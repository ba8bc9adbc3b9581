"""Carry scenes and cameras across from the JAX package.

This system has no weights: its parameters are the scene and camera
arrays, and for the cluster engine the clustered tables built from them.
Each function takes the fields of ``tpu_rt``'s ``SphereScene``,
``CameraP``, ``TriangleMesh`` or ``ClusteredScene`` (sphere or
triangle tables) as numpy arrays, e.g.
``{k: np.asarray(v) for k, v in scene._asdict().items()}``, so the two
packages can render the very same scene from the very same tables.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.types import CameraP, SphereScene, host_tensor
from ..ops.cluster import ClusteredScene
from ..ops.triangle import TriangleMesh

# scenes and meshes: object ids int32, validity bool, the rest f32
_SCENE_DTYPES = {"object_id": torch.int32, "valid": torch.bool}
# the word tables stay int32 at rest: their bf16-pair words can be f32
# denormals, which a float conversion could flush
_CLUSTER_DTYPES = {"glob_attr": torch.int32, "attr": torch.int32}


def scene_from_numpy(fields: Mapping[str, np.ndarray], device) -> SphereScene:
    """SphereScene on ``device`` from numpy fields (f32 unless integral)."""
    return SphereScene(**{
        k: host_tensor(np.asarray(fields[k]),
                       _SCENE_DTYPES.get(k, torch.float32), device)
        for k in SphereScene._fields
    })


def mesh_from_numpy(fields: Mapping[str, np.ndarray], device) -> TriangleMesh:
    """TriangleMesh on ``device`` from numpy fields, bit for bit: object
    ids int32, validity bool, the rest f32."""
    return TriangleMesh(**{
        k: host_tensor(np.asarray(fields[k]),
                       _SCENE_DTYPES.get(k, torch.float32), device)
        for k in TriangleMesh._fields
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


def clustered_from_numpy(fields: Mapping[str, np.ndarray],
                         device) -> ClusteredScene:
    """ClusteredScene on ``device`` from numpy fields: the word tables
    (``glob_attr``, ``attr``) as int32 bit for bit, the boxes and the
    background as f32."""
    return ClusteredScene(**{
        k: host_tensor(np.asarray(fields[k]),
                       _CLUSTER_DTYPES.get(k, torch.float32), device)
        for k in ClusteredScene._fields
    })
