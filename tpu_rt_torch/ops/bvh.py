"""Morton codes for the cluster build.

Counterpart of ``tpu_rt/ops/bvh.py:_expand_bits`` and ``morton_codes``;
the LBVH build and traversal of that module wait for the lax integrator
(ROADMAP.md: Queue 1). torch's uint32 support is thin, so the 30-bit
codes are computed in int64 with explicit masks; every intermediate stays
below 2^42.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits are 3 apart (the
    standard 30-bit Morton interleave), as uint32 values in int64."""
    v = v.to(torch.int64) & _M32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code per centroid, normalized to the valid rows' bbox,
    as int64 in [0, 2^32).

    Invalid (padding) primitives get the maximum code 0xFFFFFFFF so the
    sort pushes them to the tail. The bbox ignores invalid rows by masking
    them with +-inf (the JAX package's nanmin/nanmax over NaN-masked rows).
    """
    inf = torch.tensor(float("inf"), dtype=centroids.dtype,
                       device=centroids.device)
    lo = torch.where(valid[:, None], centroids, inf).amin(dim=0)
    hi = torch.where(valid[:, None], centroids, -inf).amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp((centroids - lo) / span * 1023.0, 0.0, 1023.0)
    q = q.to(torch.int64)  # truncation, as the f32 -> uint32 cast
    code = ((_expand_bits(q[:, 0]) << 2)
            | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2])) & _M32
    return torch.where(valid, code, torch.full_like(code, _M32))
