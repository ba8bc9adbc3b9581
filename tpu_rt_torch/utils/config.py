"""Typed render configuration (a copy of ``tpu_rt/utils/config.py``).

The reference's entire config system is one mutable dict of 11 keys defined
inline (interaction.py:587-599) and mutated directly by GUI handlers. Here
the same keys/defaults live in a dataclass with validation, while staying
dict-compatible (``cfg["max_samples"]`` and ``cfg.max_samples`` both work)
so GUI-shaped code keeps running.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import List


@dataclass
class RenderSettings:
    """Defaults exactly as the reference (interaction.py:587-599)."""

    max_samples: int = 32
    samples_per_batch: int = 8
    max_depth: int = 4
    exposure: float = 1.5
    enhance_image: bool = True
    show_denoisers: bool = False
    selected_denoisers: List[str] = field(default_factory=lambda: ["bilateral"])
    selected_object: int = 1
    move_speed: float = 0.3
    camera_move_speed: float = 0.1
    camera_rotate_speed: float = 0.5
    # Beyond-reference: progressive auto-stop. When > 0, the render worker
    # stops refining once the accumulated image's mean absolute change per
    # batch drops below this for two consecutive batches (converged) —
    # production serving stops paying for invisible samples. 0.0 = off
    # (the reference always runs to max_samples).
    noise_target: float = 0.0
    # Beyond-reference: next-event estimation (shadow rays to sampled
    # lights at every diffuse hit) — a much lower-variance estimator
    # (measured 34x vs the reference estimator on the small-light test
    # scene, tests/test_nee.py). Carried by both hand-written kernels
    # (ops/megakernel.py and ops/cluster.py, nee=True); physically-based
    # cosine/Lambertian transport, so the converged image differs
    # slightly from the reference look.
    nee: bool = False
    # Beyond-reference: R2 low-discrepancy stratified pixel sampling
    # (render/frame.py stratify=True) — each pixel's spp samples tile the
    # footprint quasi-uniformly; lower AA variance at equal cost.
    stratify: bool = False
    # Beyond-reference: per-tile adaptive sampling (needs noise_target > 0
    # and the megakernel engine). Tiles whose accumulated image stops
    # changing leave the render mask and cost ~nothing
    # (ops/megakernel.py tile_mask; app/interaction._render_worker).
    adaptive_tiles: bool = False

    # GUI slider ranges (gui.py:167-245): clamp on assignment
    _RANGES = {
        "max_samples": (1, 1024),
        "samples_per_batch": (1, 64),
        "max_depth": (1, 32),
        "exposure": (0.1, 5.0),
        "noise_target": (0.0, 1.0),
    }

    def __post_init__(self):
        for k in self._RANGES:
            self[k] = self[k]  # clamp initial values too

    # -- dict compatibility -------------------------------------------------
    def __getitem__(self, key: str):
        return getattr(self, key)

    def __setitem__(self, key: str, value):
        if key in self._RANGES:
            lo, hi = self._RANGES[key]
            value = type(lo)(min(hi, max(lo, value)))
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in {f.name for f in fields(self)}

    def keys(self):
        return [f.name for f in fields(self)]

    def update(self, *args, **kwargs):
        for src in args + (kwargs,):
            for k, v in dict(src).items():
                self[k] = v

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}
