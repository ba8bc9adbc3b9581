"""Batched camera rays, v1 semantics, with an optional thin lens.

Counterpart of ``tpu_rt/core/camera.py``: position/target/up pose, NDC
mapping ``(u - 0.5) * 2`` with a Y flip, ``tan(fov * 3.14159 / 360)``, a
degenerate-right fallback to +X, and thin-lens depth of field from lens
uniforms (``generate_rays(lens_xi=)``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling
from . import vecmath as vm
from .types import CameraP

# The reference uses a truncated pi; kept for bit-compatible parity.
REF_PI = 3.14159
# 2 pi rounded to f32, as JAX rounds the weak-typed ``2.0 * jnp.pi``
TWO_PI = float(np.float32(2.0 * np.pi))


def basis(cam: CameraP):
    """Forward/right/up orthonormal basis; right falls back to +X when
    forward is parallel to world-up."""
    forward = vm.normalize(cam.target - cam.position)
    profiling.count("uploads", 2)
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


def generate_rays(cam: CameraP, u: torch.Tensor, v: torch.Tensor,
                  lens_xi: torch.Tensor | None = None):
    """Rays through screen coords ``u, v`` in [0, 1].

    Returns (origins, directions), both ``u.shape + (3,)``, directions
    normalized. ``lens_xi``: optional ``u.shape + (2,)`` uniforms for thin-
    lens depth of field: origins move to a point of the disk of radius
    ``cam.aperture`` (``r = aperture sqrt(xi0)``, ``phi = 2 pi xi1``) and
    directions aim at the pinhole ray's point on the focal plane, at
    ``focus_dist`` along forward (<= 0: the look-at distance)."""
    forward, right, up = basis(cam)
    tf = tan_half_fov(cam)
    ndc_x = (u - 0.5) * 2.0
    ndc_y = (0.5 - v) * 2.0
    view_x = (ndc_x * cam.aspect * tf)[..., None]
    view_y = (ndc_y * tf)[..., None]
    direction = vm.normalize(forward + right * view_x + up * view_y)
    origin = torch.broadcast_to(cam.position, direction.shape)
    if lens_xi is None:
        return origin, direction

    focus = torch.where(cam.focus_dist > 0.0, cam.focus_dist,
                        vm.length(cam.target - cam.position))
    # the pinhole ray's point on the focal plane
    cos_f = torch.sum(direction * forward, dim=-1, keepdim=True)
    focal_pt = origin + direction * (focus / torch.clamp_min(cos_f, 1e-6))
    # uniform point of the lens disk
    r = cam.aperture * vm.sqrt(lens_xi[..., 0])
    phi = TWO_PI * lens_xi[..., 1]
    lx = (r * torch.cos(phi))[..., None]
    ly = (r * torch.sin(phi))[..., None]
    origin = origin + right * lx + up * ly
    return origin, vm.normalize(focal_pt - origin)


def pixel_uv(width: int, height: int, jitter: torch.Tensor | None = None, *,
             device, rows: int | None = None, row_offset: int = 0):
    """Screen-space (u, v) for every pixel, shape (height, width), or for
    the band of ``rows`` rows from frame row ``row_offset``, (rows, width).

    ``jitter`` is an optional (rows, width, 2) tensor in [0, 1); None
    shoots pixel centers (0.5). The sizes divide as tensors on ``device``:
    PyTorch's CUDA kernels divide by a Python scalar as a multiply by its
    reciprocal, which rounds a fifth of the coordinates apart from the
    CPU's (and JAX's) true division."""
    rows = height if rows is None else rows
    jj, ii = torch.meshgrid(
        torch.arange(rows, dtype=torch.float32, device=device) + row_offset,
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    if jitter is None:
        xu = xv = 0.5
    else:
        xu = jitter[..., 0]
        xv = jitter[..., 1]
    profiling.count("uploads", 2)
    w, h = (torch.tensor(float(n), device=device) for n in (width, height))
    return (ii + xu) / w, (jj + xv) / h
