"""Vector math over batched (..., 3) tensors: the helpers ``camera.py`` uses.

Counterpart of ``tpu_rt/core/vecmath.py``. Sums over the three components
are written out in the order the JAX package reduces them, so results agree
to the last bit or two.
"""

from __future__ import annotations

import torch

# Guard for normalizing (near-)zero vectors.
_EPS = 1e-20


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length_squared(a))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), rounded as the CUDA kernels' ``1.0f / sqrtf``.
    torch.rsqrt rounds as that on the CPU, but on CUDA it is rsqrtf, up to
    2 ulp off, which turns paths at silhouettes; there this divides."""
    return torch.rsqrt(x) if x.device.type == "cpu" else 1.0 / torch.sqrt(x)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: a zero-length vector maps to +Z (the v2 core's
    convention), so nothing downstream sees a NaN."""
    sq = length_squared(a)[..., None]
    ok = sq > _EPS
    out = a * rsqrt(torch.where(ok, sq, torch.ones_like(sq)))
    fallback = torch.zeros_like(out)
    fallback[..., 2] = 1.0
    return torch.where(ok, out, fallback)
