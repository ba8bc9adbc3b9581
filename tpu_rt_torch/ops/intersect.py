"""The packed per-sphere attribute table the megakernel reads.

Counterpart of ``tpu_rt/ops/intersect.py:attribute_matrix``; the dense
sweeps and selection raycasts of that module are not ported yet.
"""

from __future__ import annotations

import torch

from ..core.types import SphereScene


def attribute_matrix(scene: SphereScene,
                     light_cdf: torch.Tensor | None = None) -> torch.Tensor:
    """Packed (N, 16) per-sphere attribute matrix.

    Columns: center xyz, radius, albedo rgb, metallic, roughness, emission
    rgb, ior, object_id, inv_radius (0 on padding rows, which the kernel
    uses to mask them), pad: zeros, or the (N,) NEE ``light_cdf``
    (``ops/megakernel.py:light_cdf``), as the JAX package writes it there.
    """
    inv_r = torch.where(scene.radius > 0.0, 1.0 / scene.radius,
                        torch.zeros_like(scene.radius))
    return torch.cat(
        [
            scene.center,                                   # 0:3
            scene.radius[:, None],                          # 3
            scene.albedo,                                   # 4:7
            scene.metallic[:, None],                        # 7
            scene.roughness[:, None],                       # 8
            scene.emission,                                 # 9:12
            scene.ior[:, None],                             # 12
            scene.object_id.to(torch.float32)[:, None],     # 13
            inv_r[:, None],                                 # 14
            (torch.zeros_like(inv_r) if light_cdf is None
             else light_cdf.to(inv_r.dtype))[:, None],      # 15 pad
        ],
        dim=-1,
    )
