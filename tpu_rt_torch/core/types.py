"""Struct-of-arrays scene and camera types, as PyTorch tensors.

Counterpart of ``tpu_rt/core/types.py``: the same fields, padding rules and
demo data, held in ``NamedTuple``s of tensors. Every constructor takes an
explicit ``device``; nothing here reads a global default device.

Sphere counts are padded to static buckets (powers of two, min 16), so the
kernel's attribute table only changes values, never shape, on scene edits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling

MIN_SPHERE_BUCKET = 16

# Ray epsilon / infinity used by the intersectors (the reference's
# intersect(ray, 0.001f, 1e10f, ...)).
T_MIN = 1e-3
T_MAX = 1e10


class SphereScene(NamedTuple):
    """SoA sphere scene. All tensors share leading dim N (padded bucket)."""

    center: torch.Tensor     # (N, 3) f32
    radius: torch.Tensor     # (N,)   f32
    albedo: torch.Tensor     # (N, 3) f32
    metallic: torch.Tensor   # (N,)   f32
    roughness: torch.Tensor  # (N,)   f32
    emission: torch.Tensor   # (N, 3) f32
    ior: torch.Tensor        # (N,)   f32
    object_id: torch.Tensor  # (N,)   i32
    valid: torch.Tensor      # (N,)   bool
    background: torch.Tensor  # (3,)  f32

    @property
    def capacity(self) -> int:
        return self.center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device


class CameraP(NamedTuple):
    """Camera parameters, v1 semantics: position/target/up + fov/aspect.

    ``aperture`` > 0 asks for thin-lens depth of field (the lens radius,
    in world units); ``focus_dist`` <= 0 means the look-at distance.
    """

    position: torch.Tensor    # (3,) f32
    target: torch.Tensor      # (3,) f32
    up: torch.Tensor          # (3,) f32
    fov: torch.Tensor         # ()   f32, degrees
    aspect: torch.Tensor      # ()   f32
    aperture: torch.Tensor    # ()   f32
    focus_dist: torch.Tensor  # ()   f32


def host_tensor(x, dtype, device) -> torch.Tensor:
    """numpy data -> tensor on ``device`` without a stream sync (the copy
    from pageable host memory is staged before this returns); counted as
    one of the ``uploads``."""
    profiling.count("uploads")
    t = torch.from_numpy(np.array(x)).to(dtype)
    return t.to(device, non_blocking=True)


def sphere_bucket(n: int) -> int:
    """Static padded capacity for ``n`` spheres."""
    cap = MIN_SPHERE_BUCKET
    while cap < n:
        cap *= 2
    return cap


def make_scene(
    centers,
    radii,
    albedos,
    metallics,
    roughnesses,
    emissions,
    iors=None,
    object_ids=None,
    background=(0.1, 0.1, 0.1),
    capacity: int | None = None,
    *,
    device,
) -> SphereScene:
    """Build a padded SphereScene from host data on ``device``.

    Padding spheres get radius 0 and ``valid=False``."""
    centers = np.asarray(centers, np.float32).reshape(-1, 3)
    n = centers.shape[0]
    cap = capacity if capacity is not None else sphere_bucket(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < sphere count {n}")

    def pad(x, cols, fill=0.0, dtype=np.float32):
        shape = (cap,) if cols == 1 else (cap, cols)
        out = np.full(shape, fill, dtype)
        out[:n] = np.asarray(x, dtype).reshape((-1,) + shape[1:])
        return out

    if iors is None:
        iors = np.full((n,), 1.5, np.float32)
    if object_ids is None:
        object_ids = np.arange(n, dtype=np.int32)
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    f32 = torch.float32
    return SphereScene(
        center=host_tensor(pad(centers, 3), f32, device),
        radius=host_tensor(pad(radii, 1), f32, device),
        albedo=host_tensor(pad(albedos, 3), f32, device),
        metallic=host_tensor(pad(metallics, 1), f32, device),
        roughness=host_tensor(pad(roughnesses, 1), f32, device),
        emission=host_tensor(pad(emissions, 3), f32, device),
        ior=host_tensor(pad(iors, 1, fill=1.5), f32, device),
        object_id=host_tensor(pad(object_ids, 1, fill=-1, dtype=np.int32),
                              torch.int32, device),
        valid=host_tensor(valid, torch.bool, device),
        background=host_tensor(np.asarray(background, np.float32), f32,
                               device),
    )


def make_camera(
    position=(0.0, 2.0, 5.0),
    target=(0.0, 0.0, -1.0),
    up=(0.0, 1.0, 0.0),
    fov: float = 45.0,
    aspect: float = 4.0 / 3.0,
    aperture: float = 0.0,
    focus_dist: float = 0.0,
    *,
    device,
) -> CameraP:
    """Default pose matches the reference GUI init."""
    f32 = np.float32

    def t(x):
        return host_tensor(np.asarray(x, f32), torch.float32, device)

    return CameraP(
        position=t(position), target=t(target), up=t(up), fov=t(fov),
        aspect=t(aspect), aperture=t(aperture), focus_dist=t(focus_dist),
    )


# Exact data of the reference's SceneManager.create_interactive_scene:
# ground, 5 material spheres, 3 emissive lights.
# center, radius, albedo, metallic, roughness, emission
DEMO_ROWS = [
    ((0.0, -100.5, 0.0), 100.0, (0.9, 0.9, 0.9), 0.0, 0.5, (0, 0, 0)),
    ((-2.0, 0.5, -3.0), 0.5, (0.9, 0.1, 0.1), 0.9, 0.1, (0, 0, 0)),
    ((0.0, 0.5, -3.0), 0.5, (0.1, 0.9, 0.1), 0.0, 0.3, (0, 0, 0)),
    ((2.0, 0.5, -3.0), 0.5, (0.1, 0.1, 0.9), 0.0, 0.0, (0, 0, 0)),
    ((-1.0, 0.3, -1.5), 0.3, (0.9, 0.9, 0.1), 0.5, 0.2, (0, 0, 0)),
    ((1.0, 0.3, -1.5), 0.3, (0.9, 0.1, 0.9), 0.2, 0.8, (0, 0, 0)),
    ((0.0, 3.0, -1.0), 0.3, (1.0, 1.0, 1.0), 0.0, 0.1, (10, 10, 8)),
    ((-2.0, 2.0, 0.0), 0.2, (1.0, 1.0, 1.0), 0.0, 0.1, (5, 3, 2)),
    ((2.0, 2.0, 0.0), 0.2, (1.0, 1.0, 1.0), 0.0, 0.1, (2, 3, 5)),
]
DEMO_BACKGROUND = (0.05, 0.05, 0.1)

DEMO_SPHERE_NAMES = [
    "Ground", "Red Metallic", "Green Dielectric", "Blue Glass",
    "Yellow Mixed", "Purple Rough", "Main Light", "Warm Light", "Cool Light",
]


def demo_scene(capacity: int | None = None, *, device) -> SphereScene:
    """The canonical 9-sphere interactive demo scene."""
    return make_scene(
        centers=[r[0] for r in DEMO_ROWS],
        radii=[r[1] for r in DEMO_ROWS],
        albedos=[r[2] for r in DEMO_ROWS],
        metallics=[r[3] for r in DEMO_ROWS],
        roughnesses=[r[4] for r in DEMO_ROWS],
        emissions=[r[5] for r in DEMO_ROWS],
        background=DEMO_BACKGROUND,
        capacity=capacity,
        device=device,
    )
