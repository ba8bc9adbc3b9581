"""Batched pinhole camera rays, v1 semantics.

Counterpart of ``tpu_rt/core/camera.py``: position/target/up pose, NDC
mapping ``(u - 0.5) * 2`` with a Y flip, ``tan(fov * 3.14159 / 360)``, and a
degenerate-right fallback to +X. Thin-lens rays are not carried by the port
yet (ROADMAP.md: K1-refract-dof).
"""

from __future__ import annotations

import torch

from . import vecmath as vm
from .types import CameraP

# The reference uses a truncated pi; kept for bit-compatible parity.
REF_PI = 3.14159


def basis(cam: CameraP):
    """Forward/right/up orthonormal basis; right falls back to +X when
    forward is parallel to world-up."""
    forward = vm.normalize(cam.target - cam.position)
    world_up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                            device=forward.device)
    right_raw = vm.cross(forward, world_up)
    degenerate = vm.length_squared(right_raw) < 1e-6
    plus_x = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32,
                          device=forward.device)
    right = torch.where(degenerate, plus_x, vm.normalize(right_raw))
    up = vm.normalize(vm.cross(right, forward))
    return forward, right, up


def tan_half_fov(cam: CameraP) -> torch.Tensor:
    return torch.tan(cam.fov * (REF_PI / 360.0))


def generate_rays(cam: CameraP, u: torch.Tensor, v: torch.Tensor):
    """Pinhole rays through screen coords ``u, v`` in [0, 1].

    Returns (origins, directions), both ``u.shape + (3,)``, directions
    normalized."""
    forward, right, up = basis(cam)
    tf = tan_half_fov(cam)
    ndc_x = (u - 0.5) * 2.0
    ndc_y = (0.5 - v) * 2.0
    view_x = (ndc_x * cam.aspect * tf)[..., None]
    view_y = (ndc_y * tf)[..., None]
    direction = vm.normalize(forward + right * view_x + up * view_y)
    origin = torch.broadcast_to(cam.position, direction.shape)
    return origin, direction


def pixel_uv(width: int, height: int, jitter: torch.Tensor | None = None, *,
             device):
    """Screen-space (u, v) for every pixel, shape (height, width).

    ``jitter`` is an optional (height, width, 2) tensor in [0, 1); None
    shoots pixel centers (0.5)."""
    jj, ii = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    if jitter is None:
        xu = xv = 0.5
    else:
        xu = jitter[..., 0]
        xv = jitter[..., 1]
    return (ii + xu) / width, (jj + xv) / height
