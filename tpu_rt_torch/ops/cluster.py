"""The cluster engine for large sphere scenes: host-side builders, the
CUDA kernel's wrapper, and its plain PyTorch version.

Counterpart of ``tpu_rt/ops/pallas_cluster.py`` for sphere scenes: the
same Morton-clustered tables (an implicit 3-level hierarchy of
super-supers, supers of FANOUT and clusters of C spheres; the few largest
spheres swept densely as "globals"), word for word, including the
field-major cluster blocks with the cluster box in their last row and the
bf16-pair packing of the shading attributes. Tables stay int32 at rest.

The estimator is the JAX kernel's (v2, pixel jitter or centres, sqrt gamma,
per-tile segment counts), drawn from its interpret-mode counter hash in the
same order, over the same screen blocks of 32 rows x 128 lanes: the stream
of pixel (pxi, pyi) is ``flat = pyi * width + pxi`` over the padded grid
and seed ``seed + tile * spp + s``.

``render_cluster`` launches ``csrc/cluster.cu`` for scenes on a CUDA device
and runs ``render_cluster_reference`` for scenes on the CPU; there is no
other path. The plain version finds each nearest hit by sweeping the
globals and then every non-padding table row in storage order. The
hierarchy walk visits clusters in that same order and its boxes only
prune, so both compute the same function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import CameraP, SphereScene, T_MAX
from ..kernels import build
from . import megakernel as mk
from .bvh import morton_codes
from .intersect import attribute_matrix

SUBLANES = 32
LANES = 128
TILE = SUBLANES * LANES  # rays per screen block (32 rows x 128 lanes)

DEFAULT_CLUSTER = 64
DEFAULT_GLOBAL = 4
FANOUT = 8           # children per super and supers per super-super
MAX_GLOBAL = 64      # size of the kernel's shared-memory global table
BIG = 3.0e38         # inverted-box sentinel of empty clusters

_M32 = mk._M32


class ClusteredScene(NamedTuple):
    """Morton-clustered sphere scene, ready for the cluster kernel.

    glob_attr:   (G, 16) int32 words: the G largest spheres (dense sweep)
    boxes:       (K, 8) f32 cluster boxes [lo xyz, hi xyz, flag, 0]; flag
                 (col 6) is 1 for a non-empty box, 0 for an empty one
    super_boxes: (K/FANOUT, 8) f32 unions of FANOUT clusters
    ss_boxes:    (K/FANOUT^2, 8) f32 unions of FANOUT supers
    attr:        (K, C*16/128 + 1, 128) int32 field-major blocks (field f
                 of sphere j at word f*C + j); the last row holds the
                 cluster's box in lanes 0-6; padding rows have inv_r 0
    background:  (3,) f32

    Packed row layout (``_pack_attr_cols``): words 0-2 center, 3 radius,
    4 inv_r, 5 (ar, ag), 6 (ab, met), 7 (rgh, ior), 8 (er, eg), 9 (eb, 0)
    as bf16 pairs (low half first), 10-15 zero.
    """

    glob_attr: torch.Tensor
    boxes: torch.Tensor
    super_boxes: torch.Tensor
    ss_boxes: torch.Tensor
    attr: torch.Tensor
    background: torch.Tensor

    @property
    def n_global(self) -> int:
        return self.glob_attr.shape[0]

    @property
    def n_supers(self) -> int:
        return self.super_boxes.shape[0]

    @property
    def n_ss(self) -> int:
        return self.ss_boxes.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.boxes.shape[0]

    @property
    def cluster_size(self) -> int:
        return (self.attr.shape[1] - 1) * LANES // 16


# ---------------------------------------------------------------------------
# table build
# ---------------------------------------------------------------------------

def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """Bitcast f32 -> int32."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def _bits_f32(x: torch.Tensor) -> torch.Tensor:
    """Bitcast int32 -> f32."""
    return x.contiguous().view(torch.float32)


def _u32_to_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _pack_bf16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one int32 word of bf16 halves, ``a`` low and ``b``
    high, rounded to nearest even. The JAX package's uint32 rounding,
    done in int64 with masks."""
    def to_bf16_bits(x):
        bits = _f32_bits(x).to(torch.int64) & _M32
        return ((bits + 0x7FFF + ((bits >> 16) & 1)) & _M32) >> 16

    return _u32_to_i32((to_bf16_bits(b) << 16) | to_bf16_bits(a))


def _unpack_bf16_pair(word: torch.Tensor):
    """int32 word -> its (low, high) bf16 halves as f32 (the kernel's
    ``<< 16`` and ``& 0xFFFF0000``)."""
    w = word.to(torch.int64) & _M32
    return (_bits_f32(_u32_to_i32((w << 16) & _M32)),
            _bits_f32(_u32_to_i32(w & 0xFFFF0000)))


def _pack_attr_cols(attr: torch.Tensor) -> torch.Tensor:
    """(N, 16) f32 attribute rows (``attribute_matrix``) -> (N, 16) int32
    packed rows (layout in :class:`ClusteredScene`)."""
    zeros = torch.zeros_like(attr[:, 0])
    zbits = _f32_bits(zeros)
    return torch.stack([
        _f32_bits(attr[:, 0]), _f32_bits(attr[:, 1]), _f32_bits(attr[:, 2]),
        _f32_bits(attr[:, 3]), _f32_bits(attr[:, 14]),
        _pack_bf16_pair(attr[:, 4], attr[:, 5]),
        _pack_bf16_pair(attr[:, 6], attr[:, 7]),
        _pack_bf16_pair(attr[:, 8], attr[:, 12]),
        _pack_bf16_pair(attr[:, 9], attr[:, 10]),
        _pack_bf16_pair(attr[:, 11], zeros),
        zbits, zbits, zbits, zbits, zbits, zbits,
    ], dim=-1)


def build_clusters(scene: SphereScene, cluster_size: int = DEFAULT_CLUSTER,
                   n_active: int | None = None) -> ClusteredScene:
    """Sort by radius (the largest DEFAULT_GLOBAL valid spheres go
    global), Morton-order the rest into clusters of ``cluster_size``, and
    compute the boxes of all three levels, on the scene's device.

    ``n_active`` bounds the bucket to its first rows (the quantized count
    of ``render/frame.py:quantize_count``). Clusters pad to a multiple of
    FANOUT^2 so every level is full; padding clusters are empty."""
    n = scene.capacity if n_active is None else int(n_active)
    if not 1 <= n <= scene.capacity:
        raise ValueError(f"n_active={n_active} outside 1..{scene.capacity}")
    C = int(cluster_size)
    if C < 8 or (C * 16) % LANES != 0:
        raise ValueError("cluster_size must be a positive multiple of 8")
    scene = scene._replace(**{k: getattr(scene, k)[:n]
                              for k in SphereScene._fields
                              if k != "background"})
    dev = scene.device
    G = min(DEFAULT_GLOBAL, n)

    valid = scene.valid
    # globals: the G largest valid spheres (the ground and others whose
    # boxes would span the scene)
    radius_key = torch.where(valid, scene.radius,
                             torch.full_like(scene.radius, -1.0))
    glob_idx = torch.argsort(-radius_key, stable=True)[:G]
    attr_full = attribute_matrix(scene)
    glob_attr = attr_full[glob_idx]
    # invalid rows in the global set must never hit: zero their inv_r
    glob_attr[:, 14] = torch.where(valid[glob_idx], glob_attr[:, 14], 0.0)
    glob_attr = _pack_attr_cols(glob_attr)

    # the rest: Morton order, padding rows (max code) at the tail
    is_global = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_global[glob_idx] = True
    rest = valid & ~is_global
    order = torch.argsort(morton_codes(scene.center, rest), stable=True)

    K = max(1, -(-n // C))
    K = -(-K // FANOUT**2) * FANOUT**2
    pad = K * C - n
    order_p = torch.cat([order, torch.zeros(pad, dtype=order.dtype,
                                            device=dev)])
    rest_p = torch.cat([rest[order], torch.zeros(pad, dtype=torch.bool,
                                                 device=dev)])
    rows_f = attr_full[order_p]
    # padding and non-rest rows: inv_r = 0, so the sweep never takes them
    rows_f[:, 14] = torch.where(rest_p, rows_f[:, 14], 0.0)
    attr = _pack_attr_cols(rows_f)

    c = rows_f[:, 0:3].reshape(K, C, 3)
    r = rows_f[:, 3].reshape(K, C, 1)
    ok = rest_p.reshape(K, C, 1)
    lo = torch.where(ok, c - r, BIG).amin(dim=1)
    hi = torch.where(ok, c + r, -BIG).amax(dim=1)
    return _finish_hierarchy(glob_attr, attr, lo, hi, K, C, scene.background)


def _finish_hierarchy(glob_attr, attr, lo, hi, K, C, background):
    """Boxes of all three levels from the per-cluster bounds, and the
    field-major cluster blocks with the cluster's box appended as a last
    row. Empty clusters carry inverted boxes (lo = BIG, hi = -BIG), which
    the min/max unions absorb; column 6 of every box is its validity
    flag."""
    dev = lo.device

    def with_flag(lo_a, hi_a):
        flag = (lo_a[:, 0] <= hi_a[:, 0]).to(torch.float32)[:, None]
        return torch.cat([lo_a, hi_a, flag, torch.zeros_like(flag)], dim=-1)

    boxes = with_flag(lo, hi)
    S = K // FANOUT
    s_lo = lo.reshape(S, FANOUT, 3).amin(dim=1)
    s_hi = hi.reshape(S, FANOUT, 3).amax(dim=1)
    S2 = S // FANOUT
    ss_lo = s_lo.reshape(S2, FANOUT, 3).amin(dim=1)
    ss_hi = s_hi.reshape(S2, FANOUT, 3).amax(dim=1)

    blocks = attr.reshape(K, C, 16).transpose(1, 2).reshape(
        K, (C * 16) // LANES, LANES)
    box_row = torch.zeros((K, 1, LANES), dtype=torch.float32, device=dev)
    box_row[:, 0, 0:7] = boxes[:, 0:7]
    return ClusteredScene(
        glob_attr=glob_attr.contiguous(), boxes=boxes,
        super_boxes=with_flag(s_lo, s_hi), ss_boxes=with_flag(ss_lo, ss_hi),
        attr=torch.cat([blocks, _f32_bits(box_row)], dim=1).contiguous(),
        background=background.to(torch.float32))


def _box_distance(boxes: torch.Tensor, cam_pos: torch.Tensor) -> torch.Tensor:
    """Distance from the camera to each box centre; empty boxes sort last."""
    d = (boxes[..., 0:3] + boxes[..., 3:6]) * 0.5 - cam_pos
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    return torch.where(boxes[..., 0] >= BIG, 1e30, dist)


def order_clusters(cl: ClusteredScene, cam_pos: torch.Tensor
                   ) -> ClusteredScene:
    """Permute the hierarchy near to far from ``cam_pos``, level by level:
    super-supers by distance, supers within each super-super, clusters
    within each super. Storage order is the walk order, so early sweeps
    shrink each ray's best t and its slab tests prune the far boxes.

    Run it once per camera position, not per frame, and render with
    ``pre_ordered=True``."""
    F = FANOUT
    ar = torch.arange(F, device=cl.boxes.device)
    cam_pos = cam_pos.to(torch.float32)
    ss_order = torch.argsort(_box_distance(cl.ss_boxes, cam_pos), stable=True)
    sup = ss_order[:, None] * F + ar                          # (S2, F)
    s_order = torch.argsort(_box_distance(cl.super_boxes[sup], cam_pos),
                            dim=-1, stable=True)
    sup = torch.gather(sup, 1, s_order)
    child = sup[..., None] * F + ar                           # (S2, F, F)
    c_order = torch.argsort(_box_distance(cl.boxes[child], cam_pos),
                            dim=-1, stable=True)
    child = torch.gather(child, 2, c_order).reshape(-1)
    return cl._replace(ss_boxes=cl.ss_boxes[ss_order],
                       super_boxes=cl.super_boxes[sup.reshape(-1)],
                       boxes=cl.boxes[child],
                       attr=cl.attr[child].contiguous())


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------

def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpu_rt_torch's cluster engine yet "
        f"(ROADMAP.md: {item})")


def _prepare(scene, cam, width, height, spp, max_depth, cluster_size,
             n_active, prebuilt, pre_ordered, flags):
    """Validate a call; build and order the tables unless given; pack the
    camera. Returns (tables, camera (16,), blocks_x, blocks_y)."""
    for what, val, item in (
            ("refraction", flags["enable_refraction"], "K2-dof-refract"),
            ("thin-lens depth of field", flags["enable_dof"],
             "K2-dof-refract"),
            ("linear (gamma=False) output", not flags["gamma"], "K2-linear"),
            ("triangle meshes", flags["mesh"] is not None, "K2-tri"),
            ("next-event estimation (nee)", flags["nee"], "K2-nee-stratify"),
            ("stratified sampling", flags["stratify"], "K2-nee-stratify"),
            ("tile_mask adaptive sampling", flags["tile_mask"] is not None,
             "K2-tile-mask"),
            ("rows/row_offset bands", flags["rows"] is not None
             or flags["row_offset"] != 0, "K2-rows")):
        if val:
            raise _not_ported(what, item)
    for name, val in (("width", width), ("height", height), ("spp", spp),
                      ("max_depth", max_depth)):
        if int(val) < 1:
            raise ValueError(f"{name} must be >= 1, got {val}")
    cl = prebuilt if prebuilt is not None else build_clusters(
        scene, cluster_size=cluster_size, n_active=n_active)
    if not (pre_ordered and prebuilt is not None):
        cl = order_clusters(cl, cam.position)
    if cl.n_global > MAX_GLOBAL:
        raise ValueError(f"{cl.n_global} globals exceed the kernel's "
                         f"{MAX_GLOBAL}")
    if (cl.glob_attr.dtype != torch.int32 or cl.attr.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (
                cl.boxes, cl.super_boxes, cl.ss_boxes, cl.background))):
        raise TypeError("cluster tables: glob_attr and attr must be int32, "
                        "the boxes and the background float32")
    K, S2, C = cl.n_clusters, cl.n_ss, cl.cluster_size
    if (K != S2 * FANOUT**2 or cl.boxes.shape != (K, 8)
            or cl.super_boxes.shape != (S2 * FANOUT, 8)
            or cl.ss_boxes.shape != (S2, 8)
            or cl.attr.shape != (K, (C * 16) // LANES + 1, LANES)
            or cl.glob_attr.shape[1:] != (16,)
            or cl.background.shape != (3,)):
        raise ValueError("inconsistent cluster table shapes: "
                         + str({k: tuple(t.shape) for k, t in
                                cl._asdict().items()}))
    dev = cl.attr.device
    if any(t.device != dev for t in cl):
        raise ValueError("the cluster tables lie on more than one device")
    cl = ClusteredScene(*(t.contiguous() for t in cl))
    return (cl, mk._pack_camera(cam).to(dev).contiguous(),
            -(-width // LANES), -(-height // SUBLANES))


def _sweep_rows(cl: ClusteredScene) -> torch.Tensor:
    """The rows a nearest-hit search may take, in walk order: the globals,
    then every cluster row whose inv_r is positive, in storage order.
    (M, 16) int32."""
    K, C = cl.n_clusters, cl.cluster_size
    rows = cl.attr[:, :(C * 16) // LANES].reshape(K, 16, C).transpose(
        1, 2).reshape(K * C, 16)
    rows = torch.cat([cl.glob_attr, rows])
    return rows[_bits_f32(rows[:, 4]) > 0.0]


def _nearest(o, d, geo, chunk):
    """Nearest hit of each ray against every row of ``geo`` ((M, 5) f32:
    centre, radius, inv_r), taken in row order with strict ``<``, so the
    first of equal roots wins: the sequential sweep's result, computed a
    chunk of rows at a time. Returns (best t, winning row or -1)."""
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    n = ox.shape[0]
    best_t = torch.full((n,), mk._T_MAX, dtype=torch.float32, device=ox.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=ox.device)
    inf = float("inf")
    for m0 in range(0, geo.shape[0], chunk):
        cx, cy, cz, rad, inv_r = geo[m0:m0 + chunk].unbind(1)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = ocx * dx + ocy * dy + ocz * dz
        cq = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad
        # sqrt of a negative discriminant is NaN and fails every compare
        sqrtd = torch.sqrt(half_b * half_b - cq)
        root0 = -half_b - sqrtd
        root = torch.where(root0 >= 1e-3, root0, sqrtd - half_b)
        root = torch.where((root >= 1e-3) & (inv_r > 0.0), root, inf)
        cmin, carg = root.min(dim=1)  # first minimum on ties
        better = cmin < best_t
        best_t = torch.where(better, cmin, best_t)
        best_i = torch.where(better, carg + m0, best_i)
    return best_t, best_i


def _trace_plain(cl: ClusteredScene, cam, seed, width, height, spp,
                 max_depth, jitter, blocks_x, blocks_y):
    """The kernel's computation as whole-tensor PyTorch ops over every
    lane of every screen block. Returns ((height, width, 3) f32 image,
    (n_tiles,) int32 segment counts)."""
    f32 = torch.float32
    rows = _sweep_rows(cl)
    dev = rows.device
    geo = _bits_f32(rows[:, 0:5])                     # centre, radius, inv_r
    mats = [_bits_f32(rows[:, 4])]                    # inv_r
    for col in (5, 6, 8):                             # (ar,ag) (ab,met) (er,eg)
        mats += _unpack_bf16_pair(rows[:, col])
    rgh = _unpack_bf16_pair(rows[:, 7])[0]
    eb = _unpack_bf16_pair(rows[:, 9])[0]
    # the winner planes shade_plain takes: cx cy cz inv_r ar ag ab met rgh
    # er eg eb; a last row of zeros is what a miss (index -1) reads, as the
    # JAX kernel's best-hit state keeps zero planes
    table = torch.stack([geo[:, 0], geo[:, 1], geo[:, 2], mats[0], mats[1],
                         mats[2], mats[3], mats[4], rgh, mats[5], mats[6],
                         eb], dim=1)
    table = torch.cat([table, table.new_zeros((1, 12))])

    n_tiles = blocks_x * blocks_y
    n = n_tiles * TILE
    gid = torch.arange(n, dtype=torch.int64, device=dev)
    tile = gid // TILE
    pxi = (tile % blocks_x) * LANES + gid % LANES
    pyi = (tile // blocks_x) * SUBLANES + (gid % TILE) // LANES
    px, py = pxi.to(f32), pyi.to(f32)
    flat = (pyi * width + pxi) & _M32                 # the stream id
    inv_w, inv_h = mk._f32(1.0 / width), mk._f32(1.0 / height)
    (cpx, cpy, cpz, fwx, fwy, fwz, rix, riy, riz, upx, upy, upz,
     tf_aspect, tf) = cam.unbind(0)[:14]
    bg = cl.background.to(dev).unbind(0)
    # chunk the sweep to ~2^22 (CPU) or 2^26 (GPU) ray-row pairs
    budget = 1 << (26 if dev.type == "cuda" else 22)
    chunk = max(1, min(rows.shape[0], budget // n))

    acc = [torch.zeros(n, dtype=f32, device=dev) for _ in range(3)]
    segs = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for s in range(spp):
        # per-tile, per-sample seed: int32 wrap of seed + tile * spp + s
        seed_s = (tile * spp + (s + int(seed))) & _M32
        mix = flat ^ mk._mul32(seed_s, mk._C_SEED)
        salt = 0

        def U():
            # the JAX kernel's salt: a counter over its unrolled call sites
            nonlocal salt
            salt += 1
            return mk._uniform_from_mix(mix, salt)

        if jitter:
            xu = U()
            xv = U()
        else:
            xu = xv = 0.5
        u = (px + xu) * inv_w
        v = (py + xv) * inv_h
        vx = (u - 0.5) * 2.0 * tf_aspect
        vy = (0.5 - v) * 2.0 * tf
        dx, dy, dz = mk._normalize3(fwx + rix * vx + upx * vy,
                                    fwy + riy * vx + upy * vy,
                                    fwz + riz * vx + upz * vy)
        ox, oy, oz = cpx.expand(n), cpy.expand(n), cpz.expand(n)
        tr = torch.ones(n, dtype=f32, device=dev)
        tg, tb = tr, tr
        cr = torch.zeros(n, dtype=f32, device=dev)
        cg, cb = cr, cr
        act = torch.ones(n, dtype=torch.bool, device=dev)

        for depth_idx in range(1, max_depth + 1):
            segs += act.view(n_tiles, TILE).sum(1, dtype=torch.int32)
            best_t, best_i = _nearest((ox, oy, oz), (dx, dy, dz), geo, chunk)
            (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb,
             act) = mk.shade_plain((ox, oy, oz, dx, dy, dz, tr, tg, tb, cr,
                                    cg, cb, act), best_t,
                                   table[best_i].unbind(1), bg, depth_idx, U)
        acc = [acc[0] + cr, acc[1] + cg, acc[2] + cb]

    inv_spp = mk._f32(1.0 / spp)
    img = torch.stack([
        torch.clamp(torch.sqrt(torch.clamp_min(a * inv_spp, 0.0)), 0.0, 1.0)
        for a in acc], dim=-1)
    # screen blocks -> image rows and columns
    img = img.view(blocks_y, blocks_x, SUBLANES, LANES, 3).permute(
        0, 2, 1, 3, 4).reshape(blocks_y * SUBLANES, blocks_x * LANES, 3)
    return img[:height, :width].contiguous(), segs


def render_cluster_reference(
    scene: SphereScene | None,
    cam: CameraP,
    seed: int,
    *,
    width: int = 1920,
    height: int = 1080,
    spp: int = 4,
    max_depth: int = 4,
    jitter: bool = True,
    enable_refraction: bool = False,
    gamma: bool = True,
    with_stats: bool = False,
    cluster_size: int = DEFAULT_CLUSTER,
    n_active: int | None = None,
    mesh=None,
    rows: int | None = None,
    row_offset: int = 0,
    enable_dof: bool = False,
    prebuilt: ClusteredScene | None = None,
    pre_ordered: bool = False,
    nee: bool = False,
    stratify: bool = False,
    tile_mask=None,
):
    """The plain PyTorch version of the cluster kernel, on any device.

    Same contract as :func:`render_cluster`."""
    flags = dict(enable_refraction=enable_refraction, enable_dof=enable_dof,
                 gamma=gamma, mesh=mesh, nee=nee, stratify=stratify,
                 tile_mask=tile_mask, rows=rows, row_offset=row_offset)
    cl, cam_packed, blocks_x, blocks_y = _prepare(
        scene, cam, width, height, spp, max_depth, cluster_size, n_active,
        prebuilt, pre_ordered, flags)
    img, segs = _trace_plain(cl, cam_packed, seed, width, height, spp,
                             max_depth, jitter, blocks_x, blocks_y)
    return mk._finish(img, segs, width * height, blocks_x * blocks_y,
                      with_stats)


def render_cluster(
    scene: SphereScene | None,
    cam: CameraP,
    seed: int,
    *,
    width: int = 1920,
    height: int = 1080,
    spp: int = 4,
    max_depth: int = 4,
    jitter: bool = True,
    enable_refraction: bool = False,
    gamma: bool = True,
    with_stats: bool = False,
    cluster_size: int = DEFAULT_CLUSTER,
    n_active: int | None = None,
    mesh=None,
    rows: int | None = None,
    row_offset: int = 0,
    enable_dof: bool = False,
    prebuilt: ClusteredScene | None = None,
    pre_ordered: bool = False,
    nee: bool = False,
    stratify: bool = False,
    tile_mask=None,
):
    """Render one batch of ``spp`` samples of a large sphere scene through
    the cluster engine.

    Returns (height, width, 3) f32 in [0, 1], and with ``with_stats`` also
    the traced segment count over real pixels (an int32 0-dim tensor).
    ``seed`` is an int taken modulo 2^32. ``prebuilt`` passes tables from
    :func:`build_clusters` (then ``scene`` may be None); ``pre_ordered``
    promises they went through :func:`order_clusters` for this camera
    position. Otherwise the tables are built from the first ``n_active``
    rows and ordered here, per call.

    Tables on the CPU run the plain version; tables on a CUDA device launch
    the CUDA kernel (built on first use) and raise if the launch fails.
    ``render_cluster.launches`` counts kernel launches. Flags the port does
    not carry yet raise NotImplementedError naming their ROADMAP.md item.
    """
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              jitter=jitter, enable_refraction=enable_refraction,
              gamma=gamma, with_stats=with_stats, cluster_size=cluster_size,
              n_active=n_active, mesh=mesh, rows=rows, row_offset=row_offset,
              enable_dof=enable_dof,
              prebuilt=prebuilt, pre_ordered=pre_ordered, nee=nee,
              stratify=stratify, tile_mask=tile_mask)
    dev = (prebuilt.attr if prebuilt is not None else scene.center).device
    if dev.type == "cpu":
        return render_cluster_reference(scene, cam, seed, **kw)
    if dev.type != "cuda":
        raise ValueError(f"render_cluster runs on cpu or cuda, not {dev}")

    flags = {k: kw[k] for k in ("enable_refraction", "enable_dof", "gamma",
                                "mesh", "nee", "stratify", "tile_mask",
                                "rows", "row_offset")}
    cl, cam_packed, blocks_x, blocks_y = _prepare(
        scene, cam, width, height, spp, max_depth, cluster_size, n_active,
        prebuilt, pre_ordered, flags)
    lib = build.load()
    n_tiles = blocks_x * blocks_y
    with torch.cuda.device(dev):
        out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
        segs = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
        err = lib.tpurt_cluster_launch(
            cl.glob_attr.data_ptr(), cl.n_global, cl.ss_boxes.data_ptr(),
            cl.n_ss, cl.super_boxes.data_ptr(), cl.attr.data_ptr(),
            cl.cluster_size, cam_packed.data_ptr(),
            cl.background.data_ptr(), mk._signed32(seed), width, height, spp,
            max_depth, int(bool(jitter)), out.data_ptr(), segs.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cluster kernel launch failed: CUDA error {err}")
    render_cluster.launches += 1
    return mk._finish(out, segs, width * height, n_tiles, with_stats)


render_cluster.launches = 0
