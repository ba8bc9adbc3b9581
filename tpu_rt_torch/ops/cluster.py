"""The cluster engine for large scenes: host-side builders, the CUDA
kernel's wrapper, and its plain PyTorch version.

Counterpart of ``tpu_rt/ops/pallas_cluster.py`` for sphere scenes and
triangle meshes: the same Morton-clustered tables (an implicit 3-level
hierarchy of super-supers, supers of FANOUT and clusters of C primitives;
the few largest primitives swept densely as "globals"), word for word,
including the field-major cluster blocks with the cluster box in their
last row and the bf16-pair packing of the shading attributes. Tables stay
int32 at rest. A mesh has its own tables (``build_tri_clusters``), searched
after the sphere tables with the same running best hit.

The estimator is the JAX kernel's (v2 with the optional dielectric and
next-event estimation, pixel jitter, centres or the R2 lattice, a pinhole or
thin-lens camera, sqrt gamma or the linear mean, per-tile segment counts,
bands of rows and a per-block skip mask), drawn from its interpret-mode
counter hash in the same order, over the same screen blocks of 32 rows x
128 lanes: the stream of pixel (pxi, pyi) is ``flat = pyi * width + pxi``
over the padded grid and seed ``seed + tile * spp + s`` with ``tile`` the
frame's screen block (in a band too); the R2 shift's, ``seed + tile *
spp``. A winner's ior is the bf16 high half of its (rgh, ior) word. NEE
picks its lights from :func:`light_table`: the first ``n_lights_max``
emissive spheres by index, as the JAX package caps them.

``render_cluster`` launches ``csrc/cluster.cu`` for scenes on a CUDA device
and runs ``render_cluster_reference`` for scenes on the CPU; there is no
other path. The plain version finds each nearest hit by sweeping the
globals and then every non-padding table row in storage order, spheres
before triangles, and keeps the first minimum. The kernel walks the
hierarchy near to far for each ray and keeps the least (t, key), the key
being that sweep's order (:data:`KEY_SHIFT`); its boxes only prune, so
both compute the same function whatever the visit order; a shadow ray is
occluded when that search finds a hit before the light's entry t less
1e-3. :func:`walk_visits_reference` emulates the kernel's walk in its own
visit order and counts what it visits.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..core.types import CameraP, SphereScene, T_MAX
from ..kernels import build
from ..utils import profiling
from . import megakernel as mk
from .bvh import morton_codes
from .intersect import attribute_matrix

SUBLANES = 32
LANES = 128
TILE = SUBLANES * LANES  # rays per screen block (32 rows x 128 lanes)

DEFAULT_CLUSTER = 64
DEFAULT_GLOBAL = 4
DEFAULT_TRI_GLOBAL = 2  # largest-area triangles swept densely
FANOUT = 8           # children per super and supers per super-super
MAX_GLOBAL = 64      # size of the kernel's shared-memory global table
MAX_LIGHTS = 64      # rows of the kernel's shared-memory NEE light table
DEFAULT_LIGHTS = 8   # the JAX package's n_lights_max
BIG = 3.0e38         # inverted-box sentinel of empty clusters

_M32 = mk._M32


class ClusteredScene(NamedTuple):
    """Morton-clustered sphere scene (or triangle mesh, see
    :func:`build_tri_clusters`), ready for the cluster kernel.

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


def _tri_attr_rows(mesh) -> torch.Tensor:
    """Packed (T, 16) int32 triangle rows: words 0-8 the f32 bits of v0,
    e1, e2; 9-15 bf16 pairs (nx, ny), (nz, 0), (ar, ag), (ab, met),
    (rgh, ior), (er, eg), (eb, 0). Invalid rows get zero edges, which
    forces det == 0 in the sweep, so triangles need no validity word."""
    okf = mesh.valid[:, None]
    e1 = torch.where(okf, mesh.e1, 0.0)
    e2 = torch.where(okf, mesh.e2, 0.0)
    z = torch.zeros_like(mesh.ior)
    n, alb, em = mesh.normal, mesh.albedo, mesh.emission
    return torch.cat([
        _f32_bits(mesh.v0), _f32_bits(e1), _f32_bits(e2),
        torch.stack([
            _pack_bf16_pair(n[:, 0], n[:, 1]),
            _pack_bf16_pair(n[:, 2], z),
            _pack_bf16_pair(alb[:, 0], alb[:, 1]),
            _pack_bf16_pair(alb[:, 2], mesh.metallic),
            _pack_bf16_pair(mesh.roughness, mesh.ior),
            _pack_bf16_pair(em[:, 0], em[:, 1]),
            _pack_bf16_pair(em[:, 2], z),
        ], dim=-1),
    ], dim=-1)


def build_tri_clusters(mesh, cluster_size: int = DEFAULT_CLUSTER,
                       n_active: int | None = None) -> ClusteredScene:
    """Morton-cluster a TriangleMesh (the triangle analogue of
    :func:`build_clusters`: the same hierarchy and field-major blocks, rows
    of :func:`_tri_attr_rows`), on the mesh's device.

    The DEFAULT_TRI_GLOBAL largest-area valid triangles (ground quads and
    others whose boxes would span the scene) go to the dense global sweep,
    picked by a stable sort; the rest are Morton-ordered by box centre.
    Cluster boxes are the triangles' vertex bounds. ``n_active`` bounds the
    bucket to its first rows."""
    n = mesh.capacity if n_active is None else int(n_active)
    if not 1 <= n <= mesh.capacity:
        raise ValueError(f"n_active={n_active} outside 1..{mesh.capacity}")
    C = int(cluster_size)
    if C < 8 or (C * 16) % LANES != 0:
        raise ValueError("cluster_size must be a positive multiple of 8")
    mesh = mesh._replace(**{k: v[:n] for k, v in mesh._asdict().items()})
    dev = mesh.v0.device
    G = min(DEFAULT_TRI_GLOBAL, n)

    valid = mesh.valid
    rows_full = _tri_attr_rows(mesh)
    v1 = mesh.v0 + mesh.e1
    v2 = mesh.v0 + mesh.e2
    tri_min = torch.minimum(mesh.v0, torch.minimum(v1, v2))
    tri_max = torch.maximum(mesh.v0, torch.maximum(v1, v2))

    # |e1 x e2|, in the JAX package's order of operations
    (ax, ay, az), (bx, by, bz) = mesh.e1.unbind(1), mesh.e2.unbind(1)
    cx, cy, cz = ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx
    area = vm.sqrt(cx * cx + cy * cy + cz * cz)
    area_key = torch.where(valid, area, torch.full_like(area, -1.0))
    glob_idx = torch.argsort(-area_key, stable=True)[:G]
    glob_attr = rows_full[glob_idx]
    # invalid rows in the global set must never hit: zero their edges
    glob_attr[:, 3:9] = torch.where(valid[glob_idx][:, None],
                                    glob_attr[:, 3:9], 0)

    is_global = torch.zeros((n,), dtype=torch.bool, device=dev)
    is_global[glob_idx] = True
    rest = valid & ~is_global
    order = torch.argsort(morton_codes((tri_min + tri_max) * 0.5, rest),
                          stable=True)

    K = max(1, -(-n // C))
    K = -(-K // FANOUT**2) * FANOUT**2
    pad = K * C - n
    order_p = torch.cat([order, torch.zeros(pad, dtype=order.dtype,
                                            device=dev)])
    rest_p = torch.cat([rest[order], torch.zeros(pad, dtype=torch.bool,
                                                 device=dev)])
    attr = rows_full[order_p]
    attr[:, 3:9] = torch.where(rest_p[:, None], attr[:, 3:9], 0)

    ok = rest_p.reshape(K, C, 1)
    lo = torch.where(ok, tri_min[order_p].reshape(K, C, 3), BIG).amin(dim=1)
    hi = torch.where(ok, tri_max[order_p].reshape(K, C, 3), -BIG).amax(dim=1)
    return _finish_hierarchy(glob_attr, attr, lo, hi, K, C,
                             torch.zeros(3, dtype=torch.float32, device=dev))


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
    dist = vm.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
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


def light_table(scene: SphereScene,
                n_lights_max: int = DEFAULT_LIGHTS) -> torch.Tensor:
    """The cluster engine's NEE light table, (8 R + 1,) f32 on the scene's
    device with R = min(n_lights_max, capacity): the first R spheres with
    the emissive ones first (valid, max emission > 0, radius > 0; stable by
    index), each row [cx cy cz r*lw er eg eb cdf] with lw 1 for a light
    and 0 otherwise and the cdf uniform over the rows' lights, then the
    light count. As ``tpu_rt/ops/pallas_cluster.py:1735-1757``: lights past
    the first ``n_lights_max`` are neither sampled nor exempt from the
    post-diffuse suppression. Build it once per scene (``RayTracer`` does,
    at ``set_scene``)."""
    if not 1 <= int(n_lights_max) <= MAX_LIGHTS:
        raise ValueError(f"n_lights_max must be in 1..{MAX_LIGHTS}, got "
                         f"{n_lights_max}")
    em_max = scene.emission.amax(dim=-1)
    is_light = scene.valid & (em_max > 0.0) & (scene.radius > 0.0)
    order = torch.argsort((~is_light).to(torch.int8), stable=True)
    idx = order[:int(n_lights_max)]
    lw = is_light[idx].to(torch.float32)
    n_lights = lw.sum()
    cdf = torch.cumsum(lw, 0) / torch.clamp_min(n_lights, 1.0)
    rows = torch.cat([scene.center[idx], scene.radius[idx, None] * lw[:, None],
                      scene.emission[idx], cdf[:, None]], dim=-1)
    return torch.cat([rows.reshape(-1), n_lights[None]]).to(torch.float32)


# ---------------------------------------------------------------------------
# render
# ---------------------------------------------------------------------------

def _checked(cl: ClusteredScene, what: str) -> ClusteredScene:
    """Raise unless ``cl`` has the dtypes, shapes and single device the
    kernel reads; returns it with contiguous tensors."""
    if cl.n_global > MAX_GLOBAL:
        raise ValueError(f"{cl.n_global} {what} globals exceed the kernel's "
                         f"{MAX_GLOBAL}")
    if (cl.glob_attr.dtype != torch.int32 or cl.attr.dtype != torch.int32
            or any(t.dtype != torch.float32 for t in (
                cl.boxes, cl.super_boxes, cl.ss_boxes, cl.background))):
        raise TypeError(f"{what} cluster tables: glob_attr and attr must be "
                        "int32, the boxes and the background float32")
    K, S2, C = cl.n_clusters, cl.n_ss, cl.cluster_size
    if (K != S2 * FANOUT**2 or cl.boxes.shape != (K, 8)
            or cl.super_boxes.shape != (S2 * FANOUT, 8)
            or cl.ss_boxes.shape != (S2, 8)
            or cl.attr.shape != (K, (C * 16) // LANES + 1, LANES)
            or cl.glob_attr.shape[1:] != (16,)
            or cl.background.shape != (3,)):
        raise ValueError(f"inconsistent {what} cluster table shapes: "
                         + str({k: tuple(t.shape) for k, t in
                                cl._asdict().items()}))
    dev = cl.attr.device
    if any(t.device != dev for t in cl):
        raise ValueError(f"the {what} cluster tables lie on more than one "
                         "device")
    return ClusteredScene(*(t.contiguous() for t in cl))


class CheckedTables(NamedTuple):
    """The cluster kernel's tables as :func:`check_tables` returns them:
    the sphere tables, the triangle tables or None, the NEE light table
    (:func:`light_table`) or None."""

    spheres: ClusteredScene
    tris: ClusteredScene | None
    lights: torch.Tensor | None


def check_tables(cl: ClusteredScene, tri: ClusteredScene | None = None,
                 lights: torch.Tensor | None = None) -> CheckedTables:
    """Raise unless the tables (and the light table) have the dtypes and
    shapes the kernel reads, on one device; returns them contiguous. A
    caller rendering many batches from one camera position checks its
    ordered tables once and passes them as ``tables=`` (``RayTracer``
    does, per position and NEE flag)."""
    cl = _checked(cl, "sphere")
    if tri is not None:
        tri = _checked(tri, "triangle")
        if tri.attr.device != cl.attr.device:
            raise ValueError("the triangle tables lie on "
                             f"{tri.attr.device}, the sphere tables on "
                             f"{cl.attr.device}")
    if lights is not None:
        n = lights.numel() - 1
        if (lights.dtype != torch.float32 or lights.dim() != 1 or n % 8
                or not 0 <= n // 8 <= MAX_LIGHTS
                or lights.device != cl.attr.device):
            raise ValueError(
                f"lights must be a light_table: (8 R + 1,) float32 with R <= "
                f"{MAX_LIGHTS} on {cl.attr.device}, got {lights.dtype} "
                f"{tuple(lights.shape)} on {lights.device}")
        lights = lights.contiguous()
    return CheckedTables(cl, tri, lights)


def _prepare(scene, cam, *, width, height, spp, max_depth, cluster_size,
             n_active, mesh, n_tri_active, prebuilt, tri_prebuilt,
             pre_ordered, nee, n_lights_max, lights, tile_mask, rows,
             row_offset, tables, packed_camera, **_):
    """Validate a call (a band's rows and first row are multiples of 32);
    unless ``tables`` (:func:`check_tables`) are given: build and order the
    sphere tables, and the triangle tables of a mesh, unless given, with
    ``nee`` the light table, unless given, and check them; pack the camera
    unless ``packed_camera`` is given; put the tile mask on the tables'
    device. Returns (sphere tables, triangle tables or None, light table or
    None, camera (16,), blocks_x, blocks_y, band rows, first row, mask or
    None)."""
    for name, val in (("width", width), ("height", height), ("spp", spp),
                      ("max_depth", max_depth)):
        if int(val) < 1:
            raise ValueError(f"{name} must be >= 1, got {val}")
    out_rows, row0 = mk.band(width, height, rows, row_offset)
    if row0 % SUBLANES or (rows is not None and out_rows % SUBLANES):
        raise ValueError(f"band rows={rows} and row_offset={row_offset} "
                         f"must be multiples of {SUBLANES}")
    if tables is None:
        cl = prebuilt if prebuilt is not None else build_clusters(
            scene, cluster_size=cluster_size, n_active=n_active)
        if not (pre_ordered and prebuilt is not None):
            cl = order_clusters(cl, cam.position)
        tri = None
        if mesh is not None or tri_prebuilt is not None:
            tri = tri_prebuilt if tri_prebuilt is not None else (
                build_tri_clusters(mesh, cluster_size=cluster_size,
                                   n_active=n_tri_active))
            if not (pre_ordered and tri_prebuilt is not None):
                tri = order_clusters(tri, cam.position)
        if not nee:
            lights = None
        elif lights is None:
            if scene is None:
                raise ValueError("nee needs the scene or lights= from "
                                 "light_table(scene)")
            lights = light_table(scene, n_lights_max)
        tables = check_tables(cl, tri, lights)
    elif not isinstance(tables, CheckedTables):
        raise TypeError(f"tables must be the cluster engine's CheckedTables, "
                        f"got {type(tables).__name__}")
    elif ((tables.tris is None) != (mesh is None and tri_prebuilt is None)
            or (nee and tables.lights is None)):
        raise ValueError(
            f"tables do not fit this call: triangle tables "
            f"{tables.tris is not None} with a mesh "
            f"{mesh is not None or tri_prebuilt is not None}, a light table "
            f"{tables.lights is not None} with nee={bool(nee)}")
    cl, tri = tables.spheres, tables.tris
    dev = cl.attr.device
    blocks_x, blocks_y = -(-width // LANES), -(-out_rows // SUBLANES)
    return (cl, tri, tables.lights if nee else None,
            mk.pack_camera(cam, dev) if packed_camera is None
            else mk._check_camera(packed_camera, dev),
            blocks_x, blocks_y, out_rows, row0,
            mk.tile_mask_on(tile_mask, blocks_x * blocks_y, dev))


def _table_rows(cl: ClusteredScene) -> torch.Tensor:
    """Every packed row in walk order: the globals, then the cluster rows
    in storage order. (M, 16) int32."""
    K, C = cl.n_clusters, cl.cluster_size
    rows = cl.attr[:, :(C * 16) // LANES].reshape(K, 16, C).transpose(
        1, 2).reshape(K * C, 16)
    return torch.cat([cl.glob_attr, rows])


def _sweep_rows(cl: ClusteredScene) -> torch.Tensor:
    """The sphere rows a nearest-hit search may take, in walk order: those
    whose inv_r is positive. (M, 16) int32."""
    rows = _table_rows(cl)
    return rows[_bits_f32(rows[:, 4]) > 0.0]


def _tri_sweep_rows(tri: ClusteredScene) -> torch.Tensor:
    """The triangle rows a nearest-hit search may take, in walk order:
    those with an edge word that is not zero (rows with zero edges have
    det == 0 and never hit). (M, 16) int32."""
    rows = _table_rows(tri)
    return rows[(rows[:, 3:9] != 0).any(dim=1)]


def _sphere_hits(o, d, g):
    """The kernel's sphere test of rays (o, d: triples of (n, 1)) against
    rows ``g`` (..., 5: centre, radius, inv_r): (valid, root). The
    NaN-propagating root select: sqrt of a negative discriminant is NaN
    and fails every compare."""
    ocx, ocy, ocz = o[0] - g[..., 0], o[1] - g[..., 1], o[2] - g[..., 2]
    half_b = ocx * d[0] + ocy * d[1] + ocz * d[2]
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - g[..., 3] * g[..., 3]
    sqrtd = vm.sqrt(half_b * half_b - cq)
    root0 = -half_b - sqrtd
    root = torch.where(root0 >= 1e-3, root0, sqrtd - half_b)
    return (root >= 1e-3) & (g[..., 4] > 0.0), root


def _tri_hits(o, d, g):
    """Moller-Trumbore of rays against triangle rows ``g`` (..., 9: v0, e1,
    e2): (valid, t)."""
    return mk.mt_test(o, d, (g[..., 0], g[..., 1], g[..., 2]),
                      (g[..., 3], g[..., 4], g[..., 5]),
                      (g[..., 6], g[..., 7], g[..., 8]))


def _nearest(o, d, geo, chunk):
    """Nearest hit of each ray against every row of ``geo`` ((M, 5) f32:
    centre, radius, inv_r), taken in row order with strict ``<``, so the
    first of equal roots wins: the sequential sweep's result, computed a
    chunk of rows at a time. Returns (best t, winning row or -1)."""
    o = [x[:, None] for x in o]
    d = [x[:, None] for x in d]
    n = o[0].shape[0]
    best_t = torch.full((n,), mk._T_MAX, dtype=torch.float32,
                        device=o[0].device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o[0].device)
    for m0 in range(0, geo.shape[0], chunk):
        ok, root = _sphere_hits(o, d, geo[m0:m0 + chunk])
        cmin, carg = torch.where(ok, root, float("inf")).min(dim=1)
        better = cmin < best_t
        best_t = torch.where(better, cmin, best_t)
        best_i = torch.where(better, carg + m0, best_i)
    return best_t, best_i


def _nearest_tri(o, d, geo, chunk, best_t):
    """Continue the search of :func:`_nearest` over triangles (``geo``
    (M, 9) f32: v0, e1, e2), in row order with strict ``<`` against the
    running ``best_t``. Returns (best t, winning triangle row or -1)."""
    o = [x[:, None] for x in o]
    d = [x[:, None] for x in d]
    best_j = torch.full_like(best_t, -1, dtype=torch.int64)
    for m0 in range(0, geo.shape[0], chunk):
        ok, tt = _tri_hits(o, d, geo[m0:m0 + chunk])
        cmin, carg = torch.where(ok, tt, float("inf")).min(dim=1)
        better = cmin < best_t
        best_t = torch.where(better, cmin, best_t)
        best_j = torch.where(better, carg + m0, best_j)
    return best_t, best_j


def _sweep_keys(tab: ClusteredScene, tri: bool) -> torch.Tensor:
    """The walk's key (class << 28 | storage index) of each row of
    :func:`_sweep_rows` (spheres, classes 0 and 1) or
    :func:`_tri_sweep_rows` (triangles, classes 2 and 3), in their order."""
    rows = _table_rows(tab)
    keep = ((rows[:, 3:9] != 0).any(dim=1) if tri
            else _bits_f32(rows[:, 4]) > 0.0)
    pos = torch.arange(rows.shape[0], device=rows.device)[keep]
    G = tab.n_global
    cls = torch.where(pos < G, 2 if tri else 0, 3 if tri else 1)
    return (cls << KEY_SHIFT) | torch.where(pos < G, pos, pos - G)


def dense_nearest(cl: ClusteredScene, tri: ClusteredScene | None, o, d):
    """The plain version's nearest hit of each ray (o, d: triples of (R,)
    f32), by the dense sweeps :func:`_nearest` and :func:`_nearest_tri`, as
    (t, key) with the walk's key of the winner (-1: none)."""
    chunk = max(1, (1 << 22) // max(1, o[0].numel()))
    rows = _sweep_rows(cl)
    best_t, best_i = _nearest(o, d, _bits_f32(rows[:, 0:5]), chunk)
    keys = torch.cat([_sweep_keys(cl, False), best_i.new_full((1,), -1)])
    key = keys[best_i]
    if tri is not None:
        trows = _tri_sweep_rows(tri)
        best_t, best_j = _nearest_tri(o, d, _bits_f32(trows[:, 0:9]), chunk,
                                      best_t)
        tkeys = _sweep_keys(tri, True)
        key = torch.where(best_j >= 0, tkeys[best_j.clamp_min(0)], key)
    return best_t, key


# ---------------------------------------------------------------------------
# the kernel's walk, counted
# ---------------------------------------------------------------------------

KEY_SHIFT = 28  # a hit's key: class << 28 | storage index
GROUP = 8       # rows under one group box
# (lane, sample) threads of one chunk of the kernel's per-sample grid: its
# scratch is 12 B each, 201 MB, whatever spp (1080p at 8spp is one chunk)
SCRATCH_LANES = 1 << 24


def chunk_samples(spp: int, n_tiles: int) -> int:
    """Samples in each chunk of a CUDA render of ``spp`` samples over
    ``n_tiles`` screen blocks: as many as the scratch's SCRATCH_LANES
    lanes hold, at least 1 and at most ``spp``."""
    return max(1, min(spp, SCRATCH_LANES // (n_tiles * TILE)))


#: the visit counts per ray kind: slab tests at the super-super, super,
#: cluster and group levels, sphere and triangle tests (globals included),
#: and the primitive tests the warps issued (the kernel's alone; sphere
#: tests without a mesh, triangle tests with one)
VISIT_COLS = ("ss", "super", "cluster", "group", "sphere", "tri", "warp")
VISIT_KINDS = ("path", "shadow")
N_WALK_COLS = 6  # the columns walk_visits_reference counts too

# (id of a table's attr tensor, tri) -> (a weak reference to it, its boxes)
_GROUP_CACHE: dict = {}


def group_boxes(tab: ClusteredScene, tri: bool) -> torch.Tensor:
    """The port's fourth level under the carried tables: (K, C / 8, 8) f32,
    for each cluster the boxes of its rows in groups of :data:`GROUP`, in
    storage order, [lo xyz, hi xyz, flag, 0]. From the packed rows:
    spheres (``tri`` False) centre -/+ radius of the rows with inv_r > 0,
    triangles the bounds of v0, v0 + e1, v0 + e2 of the rows whose edges
    are not zero, each padded out by 1e-5 of its largest coordinate
    (+1e-6), so that rounding in the slab test never cuts off a primitive
    its cluster box lets through; a group with no such row is empty (flag
    0). Derived once per table tensor (cached on ``tab.attr``), so a
    RayTracer's tables, built at set_scene/set_mesh and ordered once per
    camera position, derive it once."""
    key = (id(tab.attr), bool(tri))
    hit = _GROUP_CACHE.get(key)
    if hit is not None and hit[0]() is tab.attr:
        return hit[1]
    K, C = tab.n_clusters, tab.cluster_size
    rows = tab.attr[:, :(C * 16) // LANES].reshape(K, 16, C)
    f = _bits_f32(rows[:, :9]).transpose(1, 2)              # (K, C, 9)
    if tri:
        v0, v1, v2 = f[..., 0:3], f[..., 0:3] + f[..., 3:6], (
            f[..., 0:3] + f[..., 6:9])
        lo = torch.minimum(v0, torch.minimum(v1, v2))
        hi = torch.maximum(v0, torch.maximum(v1, v2))
        ok = (rows[:, 3:9] != 0).any(dim=1)
    else:
        lo, hi = f[..., 0:3] - f[..., 3:4], f[..., 0:3] + f[..., 3:4]
        ok = f[..., 4] > 0.0
    pad = 1e-5 * torch.maximum(lo.abs(), hi.abs()).amax(-1, keepdim=True) \
        + 1e-6
    lo = torch.where(ok[..., None], lo - pad, BIG)
    hi = torch.where(ok[..., None], hi + pad, -BIG)
    G = C // GROUP
    lo = lo.reshape(K, G, GROUP, 3).amin(dim=2)
    hi = hi.reshape(K, G, GROUP, 3).amax(dim=2)
    flag = (lo[..., :1] <= hi[..., :1]).to(torch.float32)
    boxes = torch.cat([lo, hi, flag, torch.zeros_like(flag)], dim=-1)
    boxes = boxes.contiguous()
    _GROUP_CACHE[key] = (weakref.ref(tab.attr), boxes)
    weakref.finalize(tab.attr, _GROUP_CACHE.pop, key, None)
    return boxes


class Walk(NamedTuple):
    """What :func:`walk_visits_reference` finds for each of R rays: the
    nearest hit's t and key (-1: none; any-hit: t_edge and -1), whether it
    hit (any-hit: occluded), and the (R, 6) int64 visit counts (the first
    six :data:`VISIT_COLS`)."""

    t: torch.Tensor
    key: torch.Tensor
    hit: torch.Tensor
    visits: torch.Tensor


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """The kernel's 1 / d with |d| clamped to >= 1e-20 (cluster.cu
    safe_inv)."""
    tiny = torch.where(d >= 0.0, 1e-20, -1e-20).to(d.dtype)
    return 1.0 / torch.where(d.abs() > 1e-20, d, tiny)


def _slab(b: torch.Tensor, ray, best_t: torch.Tensor) -> torch.Tensor:
    """cluster.cu slab: the entry t of each box of ``b`` (n, m, 8) for the
    ray (origin, 1/direction: six (n, 1) planes) if it crosses it within
    [1e-3, best_t (n, 1)], else -1."""
    ox, oy, oz, ix, iy, iz = ray
    tx0, tx1 = (b[..., 0] - ox) * ix, (b[..., 3] - ox) * ix
    ty0, ty1 = (b[..., 1] - oy) * iy, (b[..., 4] - oy) * iy
    tz0, tz1 = (b[..., 2] - oz) * iz, (b[..., 5] - oz) * iz
    eps = torch.full((), 1e-3, dtype=b.dtype, device=b.device)
    enter = torch.maximum(
        torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
        torch.maximum(torch.minimum(tz0, tz1), eps))
    exit_ = torch.minimum(
        torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
        torch.minimum(torch.maximum(tz0, tz1), best_t))
    return torch.where((b[..., 6] > 0.0) & (exit_ >= enter), enter, -1.0)


class _WalkState:
    """The rays of one :func:`walk_visits_reference` call and their running
    search: best t and key, any-hit's done flags, the visit counts."""

    def __init__(self, o, d, t_edge):
        self.o, self.d = o, d
        self.inv = tuple(_safe_inv(x) for x in d)
        n = o[0].shape[0]
        self.any_hit = t_edge is not None
        self.best_t = (t_edge.clone() if self.any_hit else torch.full(
            (n,), mk._T_MAX, dtype=torch.float32, device=o[0].device))
        self.best_key = torch.full((n,), -1, dtype=torch.int64,
                                   device=o[0].device)
        self.done = torch.zeros((n,), dtype=torch.bool, device=o[0].device)
        self.visits = torch.zeros((n, N_WALK_COLS), dtype=torch.int64,
                                  device=o[0].device)

    def rays(self, idx):
        return (tuple(x[idx, None] for x in self.o),
                tuple(x[idx, None] for x in self.d))

    def slab_ray(self, idx):
        return tuple(x[idx, None] for x in self.o + self.inv)

    def test(self, idx, rows, tri, key0, whole=False):
        """Test rays ``idx`` against their rows ``rows`` (n, m, fields),
        keys key0 (n,) + column, in order; count the tests. Nearest-hit
        takes the least (t, key); any-hit stops each ray at its first
        hit, counting the rows up to it, or all of them (``whole``: rows
        the warp tests together)."""
        o, d = self.rays(idx)
        ok, t = (_tri_hits if tri else _sphere_hits)(o, d, rows)
        col = 5 if tri else 4
        m = rows.shape[1]
        if self.any_hit:
            hit = ok & (t < self.best_t[idx, None])
            anyh = hit.any(dim=1)
            first = hit.to(torch.int8).argmax(dim=1)
            self.visits[idx, col] += (m if whole else
                                      torch.where(anyh, first + 1, m))
            self.done[idx[anyh]] = True
            return
        self.visits[idx, col] += m
        cmin, carg = torch.where(ok, t, float("inf")).min(dim=1)
        key = key0 + carg
        bt, bk = self.best_t[idx], self.best_key[idx]
        win = (cmin < bt) | ((cmin == bt) & (key < bk))
        self.best_t[idx] = torch.where(win, cmin, bt)
        self.best_key[idx] = torch.where(win, key, bk)


def _walk_table(st: _WalkState, tab: ClusteredScene, tri: bool):
    """One table's globals and hierarchy, as cluster.cu sweeps and walks
    them."""
    F = FANOUT
    cls = 2 if tri else 0
    nf = 9 if tri else 5
    dev = tab.attr.device
    glob = _bits_f32(tab.glob_attr[:, :nf])
    K, C = tab.n_clusters, tab.cluster_size
    words = (C * 16) // LANES
    geo = _bits_f32(tab.attr[:, :words].reshape(K, 16, C)[:, :nf]
                    ).transpose(1, 2)                        # (K, C, nf)
    cbox = _bits_f32(tab.attr[:, words, 0:8]).reshape(-1, F, 8)
    sup = tab.super_boxes.reshape(-1, F, 8)
    ss = tab.ss_boxes

    def live(idx):
        return idx[~st.done[idx]]

    # the globals, every ray (any-hit: up to its first hit)
    idx = live(torch.arange(st.best_t.shape[0], device=dev))
    if idx.numel() and glob.shape[0]:
        st.test(idx, glob.expand(idx.numel(), -1, -1), tri,
                torch.full_like(idx, cls << KEY_SHIFT))

    groups = group_boxes(tab, tri)                          # (K, C/8, 8)

    def visit(idx, k):
        parent[idx] = k
        for gb in range(0, C // GROUP, 32):
            level(idx, groups[k, gb:gb + 32], 3,
                  lambda i, g, gb=gb: into_group(i, gb + g))

    def into_group(idx, g):
        k = parent[idx]
        rows = geo.reshape(K, C // GROUP, GROUP, nf)[k, g]
        st.test(idx, rows, tri,
                ((cls + 1) << KEY_SHIFT) + k * C + g * GROUP, whole=tri)

    def level(idx, boxes, col, descend):
        """Rays ``idx`` walk the children whose boxes are ``boxes`` (n, m,
        8), counting slab tests in column ``col``; descend(idx, child)."""
        m = torch.ones(boxes.shape[:2], dtype=torch.bool, device=dev)
        while True:
            keep = ~st.done[idx] & m.any(dim=1)
            idx, boxes, m = idx[keep], boxes[keep], m[keep]
            if idx.numel() == 0:
                return
            st.visits[idx, col] += m.sum(dim=1)
            e = _slab(boxes, st.slab_ray(idx), st.best_t[idx, None])
            m = m & (e >= 0.0)
            has = m.any(dim=1)
            sel = torch.where(m, e, float("inf")).min(dim=1)[1]
            idx, boxes, m, sel = idx[has], boxes[has], m[has], sel[has]
            m[torch.arange(idx.numel(), device=dev), sel] = False
            descend(idx, sel)

    # each level hands its child's index down through a per-ray map
    parent = torch.zeros_like(st.best_key)

    def into_clusters(idx, c):
        saved = parent[idx]
        visit(idx, saved * F + c)
        parent[idx] = saved

    def into_supers(idx, s):
        saved = parent[idx]
        sp = saved * F + s
        parent[idx] = sp
        level(idx, cbox[sp], 2, into_clusters)
        parent[idx] = saved

    for base in range(0, ss.shape[0], 32):
        chunk = ss[base:base + 32]

        def into_ss(idx, a, base=base):
            parent[idx] = base + a
            level(idx, sup[base + a], 1, into_supers)

        idx = live(torch.arange(st.best_t.shape[0], device=dev))
        level(idx, chunk.expand(idx.numel(), -1, -1), 0, into_ss)


def walk_visits_reference(cl: ClusteredScene, tri: ClusteredScene | None,
                          o, d, t_edge: torch.Tensor | None = None) -> Walk:
    """The cluster kernel's search for rays (o, d: triples of (R,) f32), in
    the kernel's own visit order, with its visit counts: the sphere globals,
    the triangle globals, the sphere walk and the triangle walk, each level
    near to far by rounds with the running best t (csrc/cluster.cu walk,
    warp_walk); the triangle walk's groups are tested whole (any-hit
    too: the warp tests a group's 8 rows at once).
    Nearest-hit keeps the least (t, key) (key = class << 28 | storage
    index), which is :func:`dense_nearest`'s winner whatever the order;
    with ``t_edge`` (R,) the rays are shadow rays, any-hit below t_edge,
    each stopping at its first hit.

    Vectorised over rays, level by level with each ray's state; returns a
    :class:`Walk`. The counts equal the counting kernel's (``render_cluster
    (..., with_visits=True)``) on the same rays."""
    n = o[0].shape[0]
    # a chunk of rays at a time: a cluster visit gathers (rays, C, 9) rows
    step = 1 << (19 if o[0].device.type == "cuda" else 16)
    if n > step:
        parts = [walk_visits_reference(
            cl, tri, tuple(x[i:i + step] for x in o),
            tuple(x[i:i + step] for x in d),
            None if t_edge is None else t_edge[i:i + step])
            for i in range(0, n, step)]
        return Walk(*(torch.cat(f) for f in zip(*parts)))
    st = _WalkState(tuple(x.to(torch.float32) for x in o),
                    tuple(x.to(torch.float32) for x in d), t_edge)
    order = ((cl, False), (tri, True)) if tri is not None else ((cl, False),)
    # the globals of both tables first, then the walks (the kernel's order)
    for tab, is_tri in order:
        _walk_table(st, tab._replace(ss_boxes=tab.ss_boxes[:0]), is_tri)
    for tab, is_tri in order:
        _walk_table(st, tab._replace(glob_attr=tab.glob_attr[:0]), is_tri)
    hit = st.done if st.any_hit else st.best_key >= 0
    return Walk(st.best_t, st.best_key, hit, st.visits)


def _winner_table(rows: torch.Tensor, cols) -> torch.Tensor:
    """(M + 1, ...) f32 planes of packed rows: for each word of ``cols``
    its f32 value, for each pair (word, "lo"/"hi") that bf16 half; the last
    row is zeros, which a miss (index -1) reads, as the JAX kernel's
    best-hit state keeps zero planes."""
    planes = []
    for c in cols:
        if isinstance(c, tuple):
            lo, hi = _unpack_bf16_pair(rows[:, c[0]])
            planes.append(lo if c[1] == "lo" else hi)
        else:
            planes.append(_bits_f32(rows[:, c]))
    table = torch.stack(planes, dim=1)
    return torch.cat([table, table.new_zeros((1, len(cols)))])


def _trace_plain(cl: ClusteredScene, tri: ClusteredScene | None, cam, seed,
                 width, height, spp, max_depth, jitter, blocks_x, blocks_y,
                 refract=False, dof=False, stratify=False, lights=None,
                 gamma=True, out_rows=None, row0=0, mask=None,
                 visits=False):
    """The kernel's computation as whole-tensor PyTorch ops over every
    lane of every screen block; with a light table ``lights``, NEE, whose
    shadow rays search every row as the nearest-hit search does. A band
    (``out_rows`` rows from frame row ``row0``) starts its pixel rows at
    ``row0`` and keys every stream by the frame's tile. Every block is
    traced; those whose ``mask`` entry is 0 are zeroed afterwards, pixels
    and segment count. Returns ((out_rows, width, 3) f32 image, (n_tiles,)
    int32 segment counts), and with ``visits`` the (n_tiles, 2, 7) int64
    visit counts of the kernel's walk over the same rays
    (:func:`walk_visits_reference`; the warp column is -1: not
    emulated)."""
    f32 = torch.float32
    rows = _sweep_rows(cl)
    dev = rows.device
    geo = _bits_f32(rows[:, 0:5])                     # centre, radius, inv_r
    # the winner planes shade_plain takes: cx cy cz inv_r ar ag ab met rgh
    # er eg eb ior, from words 0-2, 4 and the bf16 pairs of words 5-9
    table = _winner_table(rows, (0, 1, 2, 4, (5, "lo"), (5, "hi"),
                                 (6, "lo"), (6, "hi"), (7, "lo"), (8, "lo"),
                                 (8, "hi"), (9, "lo"), (7, "hi")))
    if tri is not None:
        trows = _tri_sweep_rows(tri)
        tgeo = _bits_f32(trows[:, 0:9])               # v0, e1, e2
        # the bf16 face normal (words 9-10), then the same materials as
        # the sphere rows' from words 11-15
        ttable = _winner_table(trows, ((9, "lo"), (9, "hi"), (10, "lo"),
                                       (11, "lo"), (11, "hi"), (12, "lo"),
                                       (12, "hi"), (13, "lo"), (14, "lo"),
                                       (14, "hi"), (15, "lo"), (13, "hi")))

    n_tiles = blocks_x * blocks_y
    n = n_tiles * TILE
    out_rows = height if out_rows is None else out_rows
    gid = torch.arange(n, dtype=torch.int64, device=dev)
    tile = gid // TILE
    # streams are keyed by the frame's tile, not the band's
    t_global = (row0 // SUBLANES) * blocks_x + tile
    pxi = (tile % blocks_x) * LANES + gid % LANES
    pyi = row0 + (tile // blocks_x) * SUBLANES + (gid % TILE) // LANES
    px, py = pxi.to(f32), pyi.to(f32)
    flat = (pyi * width + pxi) & _M32                 # the stream id
    inv_w, inv_h = mk._f32(1.0 / width), mk._f32(1.0 / height)
    bg = cl.background.to(dev).unbind(0)
    # the R2 shift (stratify shoots pixel centres without jitter): keyed by
    # seed + t_global * spp, shared by every sample
    shift = (mk.stratify_shift(flat, (t_global * spp + int(seed)) & _M32)
             if stratify and jitter else None)
    # chunk the sweep to ~2^22 (CPU) or 2^26 (GPU) ray-row pairs
    budget = 1 << (26 if dev.type == "cuda" else 22)
    chunk = max(1, min(rows.shape[0], budget // n))
    tchunk = max(1, budget // n)
    light = None
    vis = torch.zeros((n_tiles, 2, len(VISIT_COLS)), dtype=torch.int64,
                      device=dev)

    # every walk's rays, counted at the end by one walk per kind (path,
    # shadow): a ray's walk depends only on its own ray and t_edge, and
    # the emulation's cost is in its rounds, not its rays
    walks = ([], [])

    def count(kind, lanes, o, d, t_edge=None):
        walks[kind].append((lanes, *o, *d) + (() if t_edge is None
                                               else (t_edge,)))

    if lights is not None:
        def occluded(o, d, t_edge):
            best_t, _ = _nearest(o, d, geo, chunk)
            if tri is not None:
                best_t, _ = _nearest_tri(o, d, tgeo, tchunk, best_t)
            if visits:
                count(1, light.lanes, o, d, t_edge)
            return best_t < t_edge

        tab = lights[:-1].view(-1, 8)
        light = mk.NeePlain(lights[-1], lambda u: mk.pick_light(
            tab[:, 7], tab[:, :7], u), occluded)

    acc = [torch.zeros(n, dtype=f32, device=dev) for _ in range(3)]
    segs = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for s in range(spp):
        # per-tile, per-sample seed: int32 wrap of seed + t_global * spp + s
        seed_s = (t_global * spp + (s + int(seed))) & _M32
        mix = flat ^ mk._mul32(seed_s, mk._C_SEED)
        salt = 0

        def U():
            # the JAX kernel's salt: a counter over its unrolled call sites
            nonlocal salt
            salt += 1
            return mk._uniform_from_mix(mix, salt)

        ox, oy, oz, dx, dy, dz = mk.primary_rays(
            cam, px, py, inv_w, inv_h, s, U, jitter=jitter, dof=dof,
            shift=shift)
        tr = torch.ones(n, dtype=f32, device=dev)
        tg, tb = tr, tr
        cr = torch.zeros(n, dtype=f32, device=dev)
        cg, cb = cr, cr
        act = torch.ones(n, dtype=torch.bool, device=dev)
        if light is not None:
            light.no_emit = torch.zeros_like(act)

        for depth_idx in range(1, max_depth + 1):
            segs += act.view(n_tiles, TILE).sum(1, dtype=torch.int32)
            o, d = (ox, oy, oz), (dx, dy, dz)
            if visits:
                lanes = act.nonzero()[:, 0]
                count(0, lanes, tuple(x[lanes] for x in o),
                      tuple(x[lanes] for x in d))
            best_t, best_i = _nearest(o, d, geo, chunk)
            w = list(table[best_i].unbind(1))
            is_tri = None
            if tri is not None:
                best_t, best_j = _nearest_tri(o, d, tgeo, tchunk, best_t)
                # a triangle winner's normal n rides the sphere planes as
                # c = hit - n and 1/r = the sign that opposes n to the ray,
                # so the shading's (hit - c) * (1/r) forms it
                is_tri = best_j >= 0
                tw = ttable[best_j].unbind(1)
                nx, ny, nz = tw[0:3]
                sgn = torch.where(dx * nx + dy * ny + dz * nz < 0.0, 1.0, -1.0)
                enc = (ox + dx * best_t - nx, oy + dy * best_t - ny,
                       oz + dz * best_t - nz, sgn) + tw[3:]
                w = [torch.where(is_tri, e, p) for e, p in zip(enc, w)]
            (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb,
             act) = mk.shade_plain((ox, oy, oz, dx, dy, dz, tr, tg, tb, cr,
                                    cg, cb, act), best_t, w, bg, depth_idx, U,
                                   refract=refract, nee=light, tri=is_tri)
            if light is not None:  # one shadow segment per diffuse lane
                segs += light.diffuse.view(n_tiles, TILE).sum(
                    1, dtype=torch.int32)
        acc = [acc[0] + cr, acc[1] + cg, acc[2] + cb]

    for kind, rays in enumerate(walks):
        if rays:
            lanes, *cols = (torch.cat(c) for c in zip(*rays))
            w = walk_visits_reference(cl, tri, tuple(cols[0:3]),
                                      tuple(cols[3:6]),
                                      cols[6] if kind else None)
            vis[:, kind, :N_WALK_COLS].index_add_(0, lanes // TILE, w.visits)
    img = mk._output(acc, mk._f32(1.0 / spp), gamma)
    if mask is not None:
        on = mask != 0
        img = torch.where(on[tile, None], img, 0.0)
        segs = torch.where(on, segs, 0)
        vis = torch.where(on[:, None, None], vis, 0)
    # screen blocks -> image rows and columns
    img = img.view(blocks_y, blocks_x, SUBLANES, LANES, 3).permute(
        0, 2, 1, 3, 4).reshape(blocks_y * SUBLANES, blocks_x * LANES, 3)
    img = img[:out_rows, :width].contiguous()
    if visits:
        vis[:, :, N_WALK_COLS] = -1
        return img, segs, vis
    return img, segs


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
    n_tri_active: int | None = None,
    rows: int | None = None,
    row_offset: int = 0,
    enable_dof: bool = False,
    prebuilt: ClusteredScene | None = None,
    tri_prebuilt: ClusteredScene | None = None,
    pre_ordered: bool = False,
    nee: bool = False,
    stratify: bool = False,
    tile_mask=None,
    n_lights_max: int = DEFAULT_LIGHTS,
    lights: torch.Tensor | None = None,
    with_visits: bool = False,
    tables: CheckedTables | None = None,
    packed_camera: torch.Tensor | None = None,
):
    """The plain PyTorch version of the cluster kernel, on any device.

    Same contract as :func:`render_cluster`; its ``with_visits`` counts
    come from :func:`walk_visits_reference` over the same rays (the warp
    column is -1: the plain version has no warps), in the kernel's
    order."""
    kw = {k: v for k, v in locals().items() if k not in ("scene", "cam",
                                                         "seed")}
    (cl, tri, lights, cam_packed, blocks_x, blocks_y, out_rows, row0,
     mask) = _prepare(scene, cam, **kw)
    img, segs, *vis = _trace_plain(
        cl, tri, cam_packed, seed, width, height, spp, max_depth, jitter,
        blocks_x, blocks_y, bool(enable_refraction), bool(enable_dof),
        bool(stratify), lights, bool(gamma), out_rows, row0, mask,
        bool(with_visits))
    return mk._with_visits(mk._finish(img, segs, width * out_rows,
                                      blocks_x * blocks_y, with_stats),
                           vis[0] if vis else None)


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
    n_tri_active: int | None = None,
    rows: int | None = None,
    row_offset: int = 0,
    enable_dof: bool = False,
    prebuilt: ClusteredScene | None = None,
    tri_prebuilt: ClusteredScene | None = None,
    pre_ordered: bool = False,
    nee: bool = False,
    stratify: bool = False,
    tile_mask=None,
    n_lights_max: int = DEFAULT_LIGHTS,
    lights: torch.Tensor | None = None,
    with_visits: bool = False,
    tables: CheckedTables | None = None,
    packed_camera: torch.Tensor | None = None,
):
    """Render one batch of ``spp`` samples of a large scene through the
    cluster engine.

    Returns (height, width, 3) f32 in [0, 1] (with ``gamma=False`` the
    linear mean, unclamped), and with ``with_stats`` also the traced
    segment count over real pixels (an int32 0-dim tensor).
    ``seed`` is an int taken modulo 2^32. ``prebuilt`` passes tables from
    :func:`build_clusters` (then ``scene`` may be None); ``pre_ordered``
    promises they, and ``tri_prebuilt``, went through
    :func:`order_clusters` for this camera position. Otherwise the tables
    are built from the first ``n_active`` rows and ordered here, per call.
    ``mesh`` (or ``tri_prebuilt``, tables from :func:`build_tri_clusters`
    of its first ``n_tri_active`` rows) adds a TriangleMesh, searched
    after the spheres.

    Tables on the CPU run the plain version; tables on a CUDA device launch
    the CUDA kernel (built on first use) and raise if the launch fails.
    ``render_cluster.launches`` counts launches of the kernel: one per
    chunk of samples (a frame's samples run in chunks of
    :func:`chunk_samples`, one chunk at 1080p up to 8spp), each followed
    by one launch of its mean pass. The counter ``launches``
    (``utils/profiling.py:count``) counts every launch the call issues,
    the chunks and their mean passes: 2 per chunk, 64 for a 1080p batch
    of 256 spp (32 chunks of 8). ``enable_refraction``,
    ``enable_dof``, ``stratify`` and ``nee`` are the megakernel's (see
    ``render_megakernel``); NEE samples the light table ``lights``
    (:func:`light_table` of the scene with ``n_lights_max`` rows, built
    here when None). ``tables`` (:func:`check_tables` of the ordered
    tables and light table; then neither ``scene``, ``prebuilt`` nor
    ``lights`` is read) and ``packed_camera`` (``ops/megakernel.py:
    pack_camera`` of ``cam``) pass the kernel's inputs checked once per
    camera position and packed once per pose; without them each call
    checks and packs its own.

    ``rows``/``row_offset`` (multiples of 32) render the band of ``rows``
    image rows from frame row ``row_offset`` as a (rows, width, 3) image;
    every stream is keyed by the frame's screen block, so bands stitched
    together equal the full frame. ``tile_mask`` (adaptive sampling): one
    int per 32x128 screen block of the render, row-major (a tensor on any
    device, or a numpy array; copied to the tables' device); a block with
    0 is skipped and returns zeros and no segments, every other block the
    unmasked render's values.

    ``with_visits`` runs the kernel's counting instantiation and appends
    the (n_tiles, 2, 7) int64 visit counts: per screen block (row-major),
    for path rays and then shadow rays, the columns of
    :data:`VISIT_COLS` (slab tests per level, sphere and triangle tests,
    the primitive tests the warps issued: sphere tests without a mesh,
    triangle tests with one); the image and segments, from
    the counting instantiation, equal the timed one's.
    """
    kw = {k: v for k, v in locals().items() if k not in ("scene", "cam",
                                                         "seed")}
    given = tables.spheres if isinstance(tables, CheckedTables) else prebuilt
    dev = (given.attr if given is not None else scene.center).device
    if dev.type == "cpu":
        return render_cluster_reference(scene, cam, seed, **kw)
    if dev.type != "cuda":
        raise ValueError(f"render_cluster runs on cpu or cuda, not {dev}")

    with torch.cuda.device(dev):
        with profiling.span("prepare"):
            (cl, tri, lights, cam_packed, blocks_x, blocks_y, out_rows, row0,
             mask) = _prepare(scene, cam, **kw)
            lib = build.load()
            n_tiles = blocks_x * blocks_y
            groups = group_boxes(cl, False)
            if tri is None:  # no mesh: no triangle tables (n_tri_ss = 0)
                t_args = (0, 0, 0, 0, 0, 0, 8, 0)
            else:
                t_groups = group_boxes(tri, True)
                t_args = (tri.glob_attr.data_ptr(), tri.n_global,
                          tri.ss_boxes.data_ptr(), tri.n_ss,
                          tri.super_boxes.data_ptr(), tri.attr.data_ptr(),
                          tri.cluster_size, t_groups.data_ptr())
            out = torch.empty((out_rows, width, 3), dtype=torch.float32,
                              device=dev)
            # each (pixel, sample) thread's radiance, summed by the mean
            # pass, for one chunk of samples at a time
            chunk = chunk_samples(spp, n_tiles)
            scratch = torch.empty((chunk, 3, n_tiles * TILE),
                                  dtype=torch.float32, device=dev)
            segs = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
            vis = (torch.zeros((n_tiles, 2, len(VISIT_COLS)),
                               dtype=torch.int64, device=dev)
                   if with_visits else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
        with profiling.span("launch"):
            err = lib.tpurt_cluster_launch(
                cl.glob_attr.data_ptr(), cl.n_global, cl.ss_boxes.data_ptr(),
                cl.n_ss, cl.super_boxes.data_ptr(), cl.attr.data_ptr(),
                cl.cluster_size, groups.data_ptr(), *t_args,
                cam_packed.data_ptr(),
                cl.background.data_ptr(),
                0 if lights is None else lights.data_ptr(),
                0 if lights is None else (lights.numel() - 1) // 8,
                mk._signed32(seed), row0, out_rows, width, height, spp, chunk,
                max_depth, int(bool(jitter)), int(bool(enable_refraction)),
                int(bool(enable_dof)), int(bool(stratify)),
                int(lights is not None), int(bool(gamma)),
                0 if mask is None else mask.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), segs.data_ptr(),
                0 if vis is None else vis.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cluster kernel launch failed: CUDA error {err}")
    n_chunks = -(-spp // chunk)
    render_cluster.launches += n_chunks
    profiling.count("launches", 2 * n_chunks)
    return mk._with_visits(mk._finish(out, segs, width * out_rows, n_tiles,
                                      with_stats), vis)


render_cluster.launches = 0
