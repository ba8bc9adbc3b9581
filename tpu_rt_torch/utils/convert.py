"""Carry scenes and cameras across from the JAX package.

This system has no weights: its parameters are the scene and camera
arrays. Both functions take the fields of ``tpu_rt``'s ``SphereScene`` or
``CameraP`` as numpy arrays, e.g.
``{k: np.asarray(v) for k, v in scene._asdict().items()}``, so the two
packages can render the very same scene.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.types import CameraP, SphereScene, host_tensor

_SCENE_DTYPES = {"object_id": torch.int32, "valid": torch.bool}


def scene_from_numpy(fields: Mapping[str, np.ndarray], device) -> SphereScene:
    """SphereScene on ``device`` from numpy fields (f32 unless integral)."""
    return SphereScene(**{
        k: host_tensor(np.asarray(fields[k]),
                       _SCENE_DTYPES.get(k, torch.float32), device)
        for k in SphereScene._fields
    })


def camera_from_numpy(fields: Mapping[str, np.ndarray], device) -> CameraP:
    """CameraP on ``device`` from numpy fields; a missing or None
    aperture/focus_dist reads as 0 (pinhole, focus at the target)."""
    def get(k):
        v = fields.get(k)
        return np.float32(0.0) if v is None else np.asarray(v, np.float32)

    return CameraP(**{
        k: host_tensor(get(k), torch.float32, device)
        for k in CameraP._fields
    })
