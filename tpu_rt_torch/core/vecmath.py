"""Vector math over batched (..., 3) tensors: the helpers ``camera.py`` uses.

Counterpart of ``tpu_rt/core/vecmath.py``. Sums over the three components
are written out in the order the JAX package reduces them, so results agree
to the last bit or two. ``reflect``, ``refract`` and ``schlick`` serve the
lax integrator's metal and dielectric branches.
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


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device: the CUDA
    kernels' ``sqrtf`` (no fast-math) and JAX's ``jnp.sqrt``.

    ``torch.sqrt`` of f32 is not that on every CPU: on an AVX-512 host it
    is 1 ulp off for about one input in six. The square root is taken in
    float64 and rounded once to f32, which is exact: a double's 53 bits
    cover the 2 x 24 + 2 that correct rounding of an f32 square root
    needs. NaN, 0, subnormals and inf pass through as IEEE says."""
    return torch.sqrt(x.double()).to(x.dtype)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt(length_squared(a))


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(x), rounded as the CUDA kernels' ``1.0f / sqrtf``: a
    division by :func:`sqrt` on every device (``torch.rsqrt`` is
    ``rsqrtf`` on CUDA, up to 2 ulp off, which turns paths at
    silhouettes)."""
    return 1.0 / sqrt(x)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Safe normalize: a zero-length vector maps to +Z (the v2 core's
    convention), so nothing downstream sees a NaN."""
    sq = length_squared(a)[..., None]
    ok = sq > _EPS
    out = a * rsqrt(torch.where(ok, sq, torch.ones_like(sq)))
    fallback = torch.zeros_like(out)
    fallback[..., 2] = 1.0
    return torch.where(ok, out, fallback)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of ``v`` about the normal ``n``."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(v: torch.Tensor, n: torch.Tensor, ni_over_nt):
    """Snell refraction of ``v`` through a surface of normal ``n`` at the
    index ratio ``ni_over_nt`` (a tensor of the batch shape, or a float).
    Returns ``(can_refract, refracted)``; ``refracted`` holds only where
    ``can_refract`` is True (no total internal reflection)."""
    uv = normalize(v)
    dt = dot(uv, n)[..., None]
    ni = torch.as_tensor(ni_over_nt, dtype=uv.dtype, device=uv.device)
    if ni.dim() < dt.dim():
        ni = ni[..., None]
    disc = 1.0 - ni * ni * (1.0 - dt * dt)
    refracted = (uv - n * dt) * ni - n * sqrt(torch.clamp_min(disc, 0.0))
    return (disc > 0.0)[..., 0], refracted


def schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's Fresnel reflectance; the fifth power multiplies as JAX's
    ``** 5`` does, ``x * (x * x) * (x * x)``."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    c = 1.0 - cosine
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))
