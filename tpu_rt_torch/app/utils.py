"""Small app-layer utilities (reference: utils.py:5-26); a copy of
``tpu_rt/app/utils.py``."""

from __future__ import annotations

import threading
import time


class FrameRateLimiter:
    """Lock-guarded minimum-interval gate (utils.py:5-26)."""

    def __init__(self, max_fps: float = 30.0):
        self.min_interval = 1.0 / max_fps
        self.last_update = 0.0
        self.lock = threading.Lock()

    def should_update(self) -> bool:
        with self.lock:
            return (time.time() - self.last_update) >= self.min_interval

    def update(self):
        with self.lock:
            self.last_update = time.time()
