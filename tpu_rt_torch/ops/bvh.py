"""LBVH: a Morton-ordered complete binary tree and its skip-link traversal.

Counterpart of ``tpu_rt/ops/bvh.py``, the lax engine's intersector past
the dense sweep:

- **Build** on the device: 30-bit Morton codes of the primitives'
  centroids (int64 with masks: torch's uint32 support is thin; every
  intermediate stays below 2^42), a stable argsort by code, and a complete
  binary tree over the sorted order whose level k boxes are the pairwise
  unions of level k+1, laid out in DFS preorder.
- **Traversal**, stackless: each ray holds one node cursor and jumps by the
  precomputed skip links past culled subtrees, children in fixed order with
  closest-t pruning. The JAX package runs it as a per-ray ``while_loop``
  under ``vmap``; here every ray advances in lockstep with a masked cursor
  (``node < n_nodes``), the gathers clamped to a valid node. The loop's end
  is tested every 16 steps (each test is a device-to-host sync); a finished
  lane stays finished, so the extra steps change nothing.

The DFS order and skip links depend only on the leaf count, so they are
host numpy, cached per leaf count. Gather-bound by design: each step
indexes the node arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.types import T_MAX, T_MIN
from ..utils import profiling

_M32 = 0xFFFFFFFF
# the traversal tests for its end once per this many steps
_END_TEST_EVERY = 16


class LBVH(NamedTuple):
    """Complete-binary-tree BVH in DFS preorder.

    n_leaves is a power of two; node count = 2 * n_leaves - 1.
    ``prim_index`` maps leaf slot -> original primitive index (padding slots
    map to -1 and carry empty boxes)."""

    bbox_min: torch.Tensor    # (n_nodes, 3) f32, DFS order
    bbox_max: torch.Tensor    # (n_nodes, 3) f32
    prim_index: torch.Tensor  # (n_leaves,) i32, leaf order (= sorted order)


# ---------------------------------------------------------------------------
# static tree topology (host numpy per leaf count)
# ---------------------------------------------------------------------------

def _dfs_layout(n_leaves: int):
    """DFS preorder layout of a complete binary tree.

    Returns (heap_to_dfs, skip_link, is_leaf, leaf_slot):
      heap_to_dfs[h] = DFS position of heap node h (children 2h+1 / 2h+2)
      skip_link[d]   = DFS index to jump to when node d is culled
                       (n_nodes = terminate)
      is_leaf[d]     = 1 for leaf nodes
      leaf_slot[d]   = sorted-primitive slot for leaves, -1 otherwise
    """
    n_nodes = 2 * n_leaves - 1
    heap_to_dfs = np.zeros(n_nodes, np.int32)
    skip = np.zeros(n_nodes, np.int32)
    is_leaf = np.zeros(n_nodes, np.int32)
    leaf_slot = np.full(n_nodes, -1, np.int32)

    counter = 0
    # iterative preorder: (heap_index, skip_target) stack
    stack = [(0, n_nodes)]
    while stack:
        h, skip_to = stack.pop()
        d = counter
        counter += 1
        heap_to_dfs[h] = d
        skip[d] = skip_to
        if 2 * h + 1 >= n_nodes:  # leaf
            is_leaf[d] = 1
            leaf_slot[d] = h - (n_leaves - 1)
        else:
            # the right child is entered after the left subtree and skips
            # where we skip; the left child skips to the right child
            left_size = 2 * _subtree_leaves(h * 2 + 1, n_leaves) - 1
            stack.append((2 * h + 2, skip_to))
            stack.append((2 * h + 1, d + 1 + left_size))
    return heap_to_dfs, skip, is_leaf, leaf_slot


def _subtree_leaves(h: int, n_leaves: int) -> int:
    """Leaves under heap node h of a complete tree with n_leaves leaves."""
    size = 1
    while 2 * h + 1 < 2 * n_leaves - 1:
        h = 2 * h + 1
        size *= 2
    return size


_LAYOUT_CACHE: dict[int, tuple] = {}


def dfs_layout(n_leaves: int):
    """:func:`_dfs_layout`, cached per leaf count."""
    if n_leaves not in _LAYOUT_CACHE:
        _LAYOUT_CACHE[n_leaves] = _dfs_layout(n_leaves)
    return _LAYOUT_CACHE[n_leaves]


def _layout_on(n_leaves: int, device) -> tuple:
    """(skip, is_leaf, leaf_slot) as int64 tensors on ``device``."""
    _, skip, is_leaf, leaf_slot = dfs_layout(n_leaves)
    return tuple(torch.from_numpy(a.astype(np.int64)).to(device)
                 for a in (skip, is_leaf, leaf_slot))


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------

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
    profiling.count("uploads")
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


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _build_impl(centroids, bb_min, bb_max, valid, heap_to_dfs):
    """Sorted leaves, bottom-up pairwise unions, heap -> DFS permutation;
    returns (dfs_min, dfs_max, prim_index)."""
    n = centroids.shape[0]  # == n_leaves
    order = torch.argsort(morton_codes(centroids, valid), stable=True)
    v_sorted = valid[order][:, None]
    leaf_min = torch.where(v_sorted, bb_min[order],
                           torch.full_like(bb_min[order], T_MAX))
    leaf_max = torch.where(v_sorted, bb_max[order],
                           torch.full_like(bb_max[order], -T_MAX))

    # level k has n / 2^k nodes, in heap order
    levels_min, levels_max = [leaf_min], [leaf_max]
    m = n
    while m > 1:
        cur_min, cur_max = levels_min[-1], levels_max[-1]
        levels_min.append(torch.minimum(cur_min[0::2], cur_min[1::2]))
        levels_max.append(torch.maximum(cur_max[0::2], cur_max[1::2]))
        m //= 2

    # heap order is root level first
    heap_min = torch.cat(levels_min[::-1], dim=0)
    heap_max = torch.cat(levels_max[::-1], dim=0)
    dfs_min = torch.zeros_like(heap_min)
    dfs_max = torch.zeros_like(heap_max)
    dfs_min[heap_to_dfs] = heap_min
    dfs_max[heap_to_dfs] = heap_max
    prim_index = torch.where(valid[order], order,
                             torch.full_like(order, -1)).to(torch.int32)
    return dfs_min, dfs_max, prim_index


def build_lbvh(centroids, bb_min, bb_max, valid) -> LBVH:
    """Build the LBVH on the primitives' device from per-primitive
    centroids and boxes; ``valid`` masks real primitives. The leaf count is
    the count rounded up to a power of two (the scene buckets already are)."""
    n = centroids.shape[0]
    n_leaves = _next_pow2(n)
    if n_leaves != n:
        pad = n_leaves - n
        z3 = centroids.new_zeros((pad, 3))
        centroids = torch.cat([centroids, z3])
        bb_min = torch.cat([bb_min, z3])
        bb_max = torch.cat([bb_max, z3])
        valid = torch.cat([valid, valid.new_zeros((pad,))])
    heap_to_dfs, _, _, _ = dfs_layout(n_leaves)
    dfs_min, dfs_max, prim_index = _build_impl(
        centroids, bb_min, bb_max, valid,
        torch.from_numpy(heap_to_dfs.astype(np.int64)).to(centroids.device))
    return LBVH(bbox_min=dfs_min, bbox_max=dfs_max, prim_index=prim_index)


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def traverse(bvh: LBVH, origins: torch.Tensor, directions: torch.Tensor,
             leaf_t_fn, t_min: float, t_max: float):
    """Stackless skip-link traversal of every ray in lockstep; returns
    (t, leaf_slot) per ray (slot -1 where no leaf was hit).

    ``leaf_t_fn(slot, o, d, cur_t) -> t`` evaluates one sorted leaf per
    ray ((R,) slots, clamped to a valid slot; T_MAX on a miss)."""
    n_leaves = bvh.prim_index.shape[0]
    n_nodes = 2 * n_leaves - 1
    skip, is_leaf, leaf_slot = _layout_on(n_leaves, origins.device)
    o, d = origins, directions
    tiny = torch.where(d >= 0, 1e-20, -1e-20)
    inv_d = 1.0 / torch.where(d.abs() > 1e-20, d, tiny)

    R = o.shape[0]
    node = torch.zeros((R,), dtype=torch.int64, device=o.device)
    cur_t = torch.full((R,), t_max, dtype=torch.float32, device=o.device)
    best = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    t_big = torch.full_like(cur_t, T_MAX)
    step = 0
    while True:
        if step % _END_TEST_EVERY == 0 and not bool((node < n_nodes).any()):
            break
        step += 1
        live = node < n_nodes
        nd = torch.clamp_max(node, n_nodes - 1)
        # slab test with the running interval
        t0 = (bvh.bbox_min[nd] - o) * inv_d
        t1 = (bvh.bbox_max[nd] - o) * inv_d
        enter = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), t_min)
        exit_ = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), cur_t)
        hit_box = exit_ > enter

        leaf = is_leaf[nd] == 1
        slot = leaf_slot[nd]
        t_leaf = torch.where(
            leaf & hit_box,
            leaf_t_fn(torch.clamp_min(slot, 0), o, d, cur_t), t_big)
        better = live & (t_leaf < cur_t)
        cur_t = torch.where(better, t_leaf, cur_t)
        best = torch.where(better, slot, best)
        nxt = torch.where(hit_box & ~leaf, nd + 1, skip[nd])
        node = torch.where(live, nxt, node)
    return cur_t, best


def _prim_of(bvh: LBVH, t: torch.Tensor, slot: torch.Tensor):
    """(t, original primitive index) from a traversal's (t, slot); -1 and
    T_MAX where nothing was hit."""
    prim = torch.where(slot >= 0,
                       bvh.prim_index[torch.clamp_min(slot, 0)].long(),
                       torch.full_like(slot, -1))
    hit = (t < T_MAX) & (prim >= 0)
    return (torch.where(hit, t, torch.full_like(t, T_MAX)),
            torch.where(hit, prim, torch.full_like(prim, -1)))


def sphere_leaf_fn(scene, prim_index: torch.Tensor, t_min: float = T_MIN):
    """Per-leaf sphere intersection for :func:`traverse`: slot -> sorted
    primitive, the quadratic in the stable oc-form."""

    def leaf_t(slot, o, d, cur_t):
        idx = prim_index[slot].long()
        i = torch.clamp_min(idx, 0)
        center = scene.center[i]
        radius = scene.radius[i]
        oc = o - center
        a = vm.dot(d, d)
        half_b = vm.dot(oc, d)
        cq = vm.dot(oc, oc) - radius * radius
        disc = half_b * half_b - a * cq
        sqrtd = vm.sqrt(torch.clamp_min(disc, 0.0))
        root0 = (-half_b - sqrtd) / a
        root1 = (-half_b + sqrtd) / a
        in0 = (root0 >= t_min) & (root0 <= cur_t)
        in1 = (root1 >= t_min) & (root1 <= cur_t)
        root = torch.where(in0, root0, root1)
        ok = (idx >= 0) & (disc >= 0.0) & (in0 | in1)
        return torch.where(ok, root, torch.full_like(root, T_MAX))

    return leaf_t


def intersect_spheres_bvh(scene, bvh: LBVH, origins, directions):
    """BVH closest sphere hit: (t, original prim index) per ray, -1 and
    T_MAX on a miss."""
    t, slot = traverse(bvh, origins, directions,
                       sphere_leaf_fn(scene, bvh.prim_index), T_MIN, T_MAX)
    return _prim_of(bvh, t, slot)


def scene_lbvh(scene) -> LBVH:
    """The LBVH of a sphere scene (boxes center +- r)."""
    r = scene.radius[:, None]
    return build_lbvh(scene.center, scene.center - r, scene.center + r,
                      scene.valid)


def intersect_spheres_bvh_hit(scene, bvh: LBVH, origins, directions):
    """BVH closest hit as the ``ops/intersect.py:Hit`` record that
    ``intersect_brute`` returns, the winner's attributes gathered by its
    index: the lax engine's sphere intersector under ``use_bvh``."""
    from .intersect import Hit

    t, prim = intersect_spheres_bvh(scene, bvh, origins, directions)
    hit = prim >= 0
    idx = torch.clamp_min(prim, 0)
    center = scene.center[idx]
    radius = scene.radius[idx]
    inv_r = torch.where(radius > 0.0, 1.0 / radius,
                        torch.zeros_like(radius))
    point = origins + directions * t[:, None]
    normal = (point - center) * inv_r[:, None]
    return Hit(
        hit=hit,
        t=t,
        normal=normal,
        albedo=scene.albedo[idx],
        metallic=scene.metallic[idx],
        roughness=scene.roughness[idx],
        emission=scene.emission[idx],
        ior=scene.ior[idx],
        object_id=torch.where(hit, scene.object_id[idx].to(torch.float32),
                              torch.full_like(t, -1.0)),
    )
