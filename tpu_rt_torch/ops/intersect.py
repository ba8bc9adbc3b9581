"""Ray-sphere intersection: the packed attribute table the megakernel
reads, and the dense closest-hit sweep the first-hit AOVs use.

Counterpart of ``tpu_rt/ops/intersect.py``: ``attribute_matrix``, the
``Hit`` record, ``sphere_ts`` (every ray against every sphere, with the
quadratic's cross terms as (R, 3) x (3, N) products),
``intersect_brute`` (the first sphere at the least t, its t solved again
in the stable oc-form) and ``combine_hits``. The products are written out
as broadcast multiplies and adds (the same sums, in a fixed order), so a
run on the card gives the CPU's values whatever the global matmul
precision; the winner's attributes are its row of the attribute table,
which is what the JAX package's one-hot product fetches.
``closest_object_id`` is the selection raycast of one ray.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..core.types import T_MAX, T_MIN, SphereScene


class Hit(NamedTuple):
    """Struct-of-arrays hit records for a batch of rays, with the winner's
    attributes fetched."""

    hit: torch.Tensor        # (R,)   bool
    t: torch.Tensor          # (R,)   f32 (T_MAX where miss)
    normal: torch.Tensor     # (R, 3) f32 outward normal
    albedo: torch.Tensor     # (R, 3) f32
    metallic: torch.Tensor   # (R,)   f32
    roughness: torch.Tensor  # (R,)   f32
    emission: torch.Tensor   # (R, 3) f32
    ior: torch.Tensor        # (R,)   f32
    object_id: torch.Tensor  # (R,)   f32 (exact for ids < 2^24; -1 on miss)


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


def outer_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, 3) x (N, 3) -> (R, N) dot products, summed x + y + z in
    order."""
    return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]
            + a[:, None, 2] * b[None, :, 2])


def sphere_ts(
    scene: SphereScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> torch.Tensor:
    """Nearest valid hit parameter per (ray, sphere), T_MAX where none.

    origins/directions: (R, 3). Returns (R, N) f32. The quadratic per pair
    (oc = o - c; a = d.d; half_b = oc.d; cq = oc.oc - r^2), decomposed as
    the JAX package decomposes it: half_b = o.d - D C^T and
    cq = |o|^2 - 2 O C^T + |c|^2 - r^2."""
    d_dot_c = outer_dot(directions, scene.center)
    o_dot_c = outer_dot(origins, scene.center)

    a = vm.dot(directions, directions)[:, None]                    # (R, 1)
    o_dot_d = vm.dot(origins, directions)[:, None]                 # (R, 1)
    o_sq = vm.dot(origins, origins)[:, None]                       # (R, 1)
    c_sq = vm.dot(scene.center, scene.center)                      # (N,)
    r_sq = scene.radius * scene.radius                             # (N,)

    half_b = o_dot_d - d_dot_c                                     # (R, N)
    cq = o_sq - 2.0 * o_dot_c + (c_sq - r_sq)[None, :]             # (R, N)

    disc = half_b * half_b - a * cq
    feasible = disc >= 0.0
    sqrtd = vm.sqrt(torch.clamp_min(disc, 0.0))
    inv_a = 1.0 / a
    root0 = (-half_b - sqrtd) * inv_a
    root1 = (-half_b + sqrtd) * inv_a

    in0 = (root0 >= t_min) & (root0 <= t_max)
    in1 = (root1 >= t_min) & (root1 <= t_max)
    root = torch.where(in0, root0, root1)
    ok = feasible & (in0 | in1) & scene.valid[None, :]
    return torch.where(ok, root, torch.full_like(root, T_MAX))


def _first_hit_onehot(ts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, N) f32 one-hot of the first primitive achieving the least t;
    ties go to the lowest index, miss rows (t == T_MAX) are all zero."""
    at_min = (ts <= t[:, None]) & (t[:, None] < T_MAX)
    first = torch.cumsum(at_min.to(torch.int32), dim=-1) == 1
    return (at_min & first).to(torch.float32)


def _fetch(sel: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """The one-hot ``sel``'s row of ``attr`` per ray (zeros on a miss): the
    values of the product ``sel @ attr``, gathered."""
    rows = attr.index_select(0, sel.argmax(dim=-1))
    return torch.where(sel.amax(dim=-1, keepdim=True) > 0, rows,
                       torch.zeros_like(rows))


def _refine_t(center, radius, origins, directions, t_min, t_max, coarse_t):
    """Re-solve the winning sphere's quadratic in the stable oc-form (the
    expanded form cancels for grazing rays)."""
    oc = origins - center
    a = vm.dot(directions, directions)
    half_b = vm.dot(oc, directions)
    cq = vm.dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * cq
    sqrtd = vm.sqrt(torch.clamp_min(disc, 0.0))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 >= t_min) & (root0 <= t_max)
    in1 = (root1 >= t_min) & (root1 <= t_max)
    root = torch.where(in0, root0, root1)
    ok = (disc >= 0.0) & (in0 | in1)
    return torch.where(ok, root, coarse_t)


def intersect_brute(
    scene: SphereScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float = T_MIN,
    t_max: float = T_MAX,
    attr: torch.Tensor | None = None,
) -> Hit:
    """Closest hit over all spheres: the least t, the first sphere at it,
    and its attributes. ``attr`` is ``attribute_matrix(scene)`` when the
    caller has it."""
    if attr is None:
        attr = attribute_matrix(scene)
    ts = sphere_ts(scene, origins, directions, t_min, t_max)       # (R, N)
    t = ts.amin(dim=-1)                                             # (R,)
    hit = t < T_MAX
    fetched = _fetch(_first_hit_onehot(ts, t), attr)               # (R, 16)

    center = fetched[:, 0:3]
    radius = fetched[:, 3]
    inv_r = fetched[:, 14]
    t = _refine_t(center, radius, origins, directions, t_min, t_max, t)
    point = origins + directions * t[:, None]
    normal = (point - center) * inv_r[:, None]
    return Hit(
        hit=hit,
        t=torch.where(hit, t, torch.full_like(t, T_MAX)),
        normal=normal,
        albedo=fetched[:, 4:7],
        metallic=fetched[:, 7],
        roughness=fetched[:, 8],
        emission=fetched[:, 9:12],
        ior=fetched[:, 12],
        object_id=torch.where(hit, fetched[:, 13],
                              torch.full_like(t, -1.0)),
    )


def closest_object_id(
    scene: SphereScene,
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_min: float = T_MIN,
    t_max: float = 1000.0,
    skip_object_id: int | None = None,
) -> torch.Tensor:
    """Object id of the nearest sphere along one ray ((3,) origin and
    direction), -1 on a miss, as a 0-d tensor; ``skip_object_id`` leaves
    that object out (the selection path's ground skip)."""
    ts = sphere_ts(scene, origin[None, :], direction[None, :], t_min,
                   t_max)[0]
    if skip_object_id is not None:
        ts = torch.where(scene.object_id == skip_object_id,
                         torch.full_like(ts, T_MAX), ts)
    idx = torch.argmin(ts)
    return torch.where(ts[idx] < T_MAX, scene.object_id[idx],
                       torch.full_like(scene.object_id[idx], -1))


def combine_hits(a: Hit, b: Hit) -> Hit:
    """Merge two closest-hit records (spheres and triangles): the nearer
    surface wins per ray."""
    bw = b.t < a.t
    bw3 = bw[:, None]
    return Hit(
        hit=a.hit | b.hit,
        t=torch.where(bw, b.t, a.t),
        normal=torch.where(bw3, b.normal, a.normal),
        albedo=torch.where(bw3, b.albedo, a.albedo),
        metallic=torch.where(bw, b.metallic, a.metallic),
        roughness=torch.where(bw, b.roughness, a.roughness),
        emission=torch.where(bw3, b.emission, a.emission),
        ior=torch.where(bw, b.ior, a.ior),
        object_id=torch.where(bw, b.object_id, a.object_id),
    )
