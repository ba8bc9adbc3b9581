"""JAX's threefry random streams in PyTorch, and the path tracer's samplers.

Counterpart of ``tpu_rt/core/rng.py`` and of the ``jax.random`` functions
it stands on, under JAX's partitionable threefry (``threefry2x32``,
``jax_threefry_partitionable=True``): the same key gives the same bits, so
the port's lax engine draws the JAX package's samples.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(torch's uint32 support is thin); every add and rotate is masked back to
32 bits. A leading batch of keys ``(*B, 2)`` is allowed everywhere: each
key draws its own stream, and a draw of ``shape`` returns ``(*B, *shape)``.
Draws stay on the key's device.

- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- ``split(key, n)`` and ``bits(key, shape)`` hash the counters of a 64-bit
  iota over the shape as (hi, lo) words; ``split`` keeps both outputs as the
  new key, ``bits`` returns their XOR;
- ``uniform`` fills the mantissa of 1.0 with the top 23 bits, minus 1;
- ``normal`` is ``sqrt(2) * erfinv(u)``, u uniform in (nextafter(-1, 0),
  1), with the single-precision polynomial of Giles that XLA uses for
  ``erf_inv`` (``torch.erfinv`` rounds tens of ulps away from it).

The samplers are distribution-exact versions of the reference's rejection
loops: ``unit_ball`` is a normalized gaussian direction times a
cube-root radius, ``hemisphere`` flips it onto the normal's side.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import profiling
from . import vecmath as vm

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# Giles, "Approximating the erfinv function" (single precision), as XLA
# evaluates it: w = -log1p(-x^2); w < 5 and w >= 5 polynomials.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2)))
# jax.random.normal's lower bound, nextafter(-1, 0) in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def key(seed: int, *, device="cuda") -> torch.Tensor:
    """The key of an integer seed, ``[seed >> 32, seed & 0xFFFFFFFF]``:
    ``[0, seed]`` for the 0 <= seed < 2^31 seeds the API uses, as
    ``jax.random.key(seed)``."""
    seed = int(seed)
    profiling.count("uploads")
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k1, k2); uint32 values in int64 tensors (or ints),
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_iota(k: torch.Tensor, shape) -> tuple:
    """threefry2x32 of each key over the counters of a 64-bit iota of
    ``shape`` (hi, lo words): two (*B, *shape) words."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    c = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    kk = k.reshape(k.shape[:-1] + (1,) * len(shape) + (2,))
    return threefry2x32(kk[..., 0], kk[..., 1], c >> 32, c & _M32)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from each key: (*B, num, 2)."""
    b1, b2 = _hash_iota(k, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """The key of ``data`` folded into each key: (*B, 2). ``data`` may be a
    tensor of ints, broadcast against the keys' batch."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack([b1, b2], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, as int64 in [0, 2^32): (*B, *shape)."""
    b1, b2 = _hash_iota(k, shape)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """U[0, 1) float32 draws, bit for bit ``jax.random.uniform``."""
    mant = (bits(k, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv of f32 ``x`` in (-1, 1) by the single-precision polynomial of
    Giles that XLA evaluates, its steps contracted into multiply-adds (the
    product of two f32 is exact in float64, so each step rounds once).
    log1p is taken in float64 and rounded once, so the card and the CPU
    agree."""
    w = -torch.log1p(-(x * x).double()).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, vm.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, lo), torch.full_like(x, hi))
        p = (p.double() * w.double() + c.double()).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max),
                       p * x)


def normal(k: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal float32 draws, as ``jax.random.normal``: a uniform
    in (nextafter(-1, 0), 1) through sqrt(2) * erfinv."""
    f = uniform(k, shape)
    span = float(np.float32(1.0) - np.float32(_NORMAL_LO))
    u = torch.clamp_min(f * span + _NORMAL_LO, _NORMAL_LO)
    return _SQRT2 * erfinv(u)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root of f32 ``x`` (taken in float64, rounded once)."""
    xd = x.double()
    return (torch.sign(xd) * xd.abs().pow(1.0 / 3.0)).to(x.dtype)


def unit_ball(k: torch.Tensor, shape) -> torch.Tensor:
    """Uniform samples in the unit ball, (*B, *shape, 3): an isotropic
    direction (a normalized gaussian) times radius u^(1/3)."""
    kg, ku = split(k, 2).unbind(dim=-2)
    shape = tuple(shape)
    d = vm.normalize(normal(kg, shape + (3,)))
    r = cbrt(uniform(ku, shape + (1,)))
    return d * r


def hemisphere(k: torch.Tensor, normal_: torch.Tensor) -> torch.Tensor:
    """A unit-ball sample flipped onto the side of ``normal_``."""
    p = unit_ball(k, normal_.shape[:-1])
    side = (vm.dot(p, normal_) > 0.0)[..., None]
    return torch.where(side, p, -p)
