"""Denoiser bank with the reference's class API (denoiser.py:4-44).

Counterpart of ``tpu_rt/app/denoiser.py``: the same four methods and
default parameters, plus "joint" (the AOV-guided bilateral). The filters
run through ``tpu_rt_torch.ops.post`` on the Denoiser's device (the card
unless the caller asks for the CPU); ``backend="cv2"`` filters on the host
with OpenCV, when it is installed, for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import post
from ..render.display import STACKABLE, _apply_method


class Denoiser:
    """Denoising algorithms (reference: denoiser.py:4-44)."""

    def __init__(self, backend: str = "torch", device="cuda"):
        # "joint" (feature-guided bilateral over render AOVs) extends the
        # reference's four color-only methods; it needs aovs= and has no
        # cv2 counterpart.
        self.available_methods = ["bilateral", "nlmeans", "gaussian",
                                  "median", "joint"]
        self.backend = backend
        self.device = torch.device(device)

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def denoise(self, image, method: str = "bilateral", aovs=None,
                **kwargs) -> np.ndarray:
        """(h, w, 3) image in [0, 1] (numpy or tensor) -> denoised (h, w, 3)
        float32 numpy array. "joint" takes ``aovs`` (``render/aov.py:
        render_aovs``'s dict) and runs on the device whatever the
        backend."""
        if method == "joint":
            if aovs is None:
                raise ValueError(
                    "method='joint' needs aovs= (tpu_rt_torch.render.aov."
                    "render_aovs output)")
            out = post.joint_bilateral(
                self._on_device(image), self._on_device(aovs["normal"]),
                self._on_device(aovs["depth"]),
                d=kwargs.get("d", 9),
                sigma_color=kwargs.get("sigma_color", 75),
                sigma_space=kwargs.get("sigma_space", 75),
                sigma_normal=kwargs.get("sigma_normal", 0.25),
                sigma_depth=kwargs.get("sigma_depth", 0.08),
            )
            return out.cpu().numpy()
        if self.backend == "cv2":
            return self._denoise_cv2(np.asarray(
                image.cpu() if torch.is_tensor(image) else image), method,
                **kwargs)
        if method not in STACKABLE:
            raise ValueError(f"Unknown denoising method: {method}")
        return _apply_method(method, self._on_device(image),
                             **kwargs).cpu().numpy()

    def _denoise_cv2(self, image, method, **kwargs):
        import cv2

        u8 = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        if method == "bilateral":
            out = cv2.bilateralFilter(u8, kwargs.get("d", 9),
                                      kwargs.get("sigma_color", 75),
                                      kwargs.get("sigma_space", 75))
        elif method == "nlmeans":
            out = cv2.fastNlMeansDenoisingColored(
                u8, None, kwargs.get("h", 10), kwargs.get("h", 10),
                kwargs.get("template_window_size", 7),
                kwargs.get("search_window_size", 21))
        elif method == "gaussian":
            k = kwargs.get("kernel_size", 5)
            out = cv2.GaussianBlur(u8, (k, k), kwargs.get("sigma", 1.0))
        elif method == "median":
            out = cv2.medianBlur(u8, kwargs.get("kernel_size", 5))
        else:
            raise ValueError(f"Unknown denoising method: {method}")
        return out.astype(np.float32) / 255.0
