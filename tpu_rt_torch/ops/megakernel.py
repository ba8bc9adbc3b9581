"""The path-trace megakernel: CUDA kernel wrapper and its plain version.

Counterpart of ``tpu_rt/ops/pallas_megakernel.py`` for the configurations
the main render path and the small-mesh path run: sphere scenes of at most
64 spheres, optionally beside a triangle mesh of at most 256 triangles
(scalar Moller-Trumbore after the sphere sweep; a triangle winner shades
with its f32 face normal flipped to oppose the ray), the v2 estimator
(miss adds throughput x background; emission before Russian roulette; RR
after bounce 3 with p = clamp(max throughput, 0.1, 0.95) and survivor
compensation; metal mirrors with roughness jitter, else diffuse
normalize(normal + hemisphere-flipped ball point); with
``enable_refraction`` a dielectric with Schlick's reflectance; with ``nee``
next-event estimation: the cosine diffuse sampler, one shadow ray per
diffuse hit to a solid-angle-sampled emissive sphere picked from the light
cdf of :func:`light_cdf`, and the post-diffuse suppression of sphere
emission), pixel jitter, pixel centres or the R2 lattice (``stratify``), a
pinhole or thin-lens camera (``enable_dof``), the spp mean with sqrt gamma
and clamp or linear (``gamma=False``), per-tile segment counts, bands of
rows (``rows``/``row_offset``) and a per-tile skip mask (``tile_mask``).

The kernel (``csrc/megakernel.cu``) and the plain PyTorch version here both
draw from the JAX kernel's interpret-mode counter hash in the same order,
so either can be compared stream for stream with
``render_pallas(..., interpret=True)``. Pixels are grouped into tiles of
4096 as on the TPU: the per-tile seed and segment count depend on it.

``render_megakernel`` runs the plain version for scenes on the CPU and the
CUDA kernel for scenes on a CUDA device; there is no other path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cammod
from ..core import vecmath as vm
from ..core.types import CameraP, SphereScene, T_MAX
from ..kernels import build
from ..utils import profiling
from .intersect import attribute_matrix

TILE = 4096          # rays per TPU tile (32 sublanes x 128 lanes)
RR_START = 3         # Russian roulette after this many bounces
MAX_SPHERES = 64     # size of the kernel's shared-memory attribute table
MAX_TRIS = 256       # size of the kernel's shared-memory triangle table
#: the visit counts per ray kind (path, shadow): segments, sphere tests,
#: triangle tests (a shadow ray's up to its first blocker), and the tests
#: the warps issued (the kernel's alone)
VISIT_COLS = ("segments", "sphere", "tri", "warp")
VISIT_KINDS = ("path", "shadow")

_M32 = 0xFFFFFFFF
# int32 multipliers of the JAX hash (-1640531527, -2048144789,
# -1028477387) read as uint32
_C_SEED = 2654435769
_C_MIX1 = 2246822507
_C_MIX2 = 3266489909


def _f32(x: float) -> float:
    """A Python float rounded to f32, as JAX rounds weak-typed scalars."""
    return float(np.float32(x))


_TWO_PI = _f32(6.2831853071795864)
_THIRD = _f32(1.0 / 3.0)
_INV_PI = _f32(0.3183098861837907)  # the NEE estimator's 1/pi
_T_MAX = _f32(T_MAX)
# R2 lattice steps (tpu_rt/ops/pallas_megakernel.py:R2_ALPHA_U/V)
R2_ALPHA_U = 0.7548776662466927
R2_ALPHA_V = 0.5698402909980532


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): split ``c`` in 16-bit
    halves so no intermediate leaves the int64 range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _M32


def _uniform_from_mix(mix: torch.Tensor, salt: int) -> torch.Tensor:
    """Finish the hash of ``mix = pix ^ (seed * C)`` for one call site."""
    h = (mix + salt * 40503) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, _C_MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C_MIX2)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _hash_uniform(pix, seed, salt: int) -> torch.Tensor:
    """Counter-hash U[0,1): the JAX kernel's ``_hash_uniform`` (murmur3-style
    finalizer over pixel id, stream seed and call salt), bit for bit. The
    JAX version wraps in int32; this one works on uint32 values held in
    int64."""
    return _uniform_from_mix(_u32(pix) ^ _mul32(_u32(seed), _C_SEED), salt)


def _pack_camera(cam: CameraP) -> torch.Tensor:
    """[pos3, fwd3, right3, up3, tf*aspect, tf, aperture, focus] as (16,)
    f32; focus <= 0 resolves to the look-at distance."""
    forward, right, up = cammod.basis(cam)
    tf = cammod.tan_half_fov(cam)
    look = vm.length(cam.target - cam.position)
    focus = torch.where(cam.focus_dist > 0.0, cam.focus_dist, look)
    return torch.cat([
        cam.position, forward, right, up,
        torch.stack([tf * cam.aspect, tf, cam.aperture, focus]),
    ]).to(torch.float32)


def pack_camera(cam: CameraP, device) -> torch.Tensor:
    """The kernels' packed camera (:func:`_pack_camera`), contiguous on
    ``device``. It depends on the pose alone: a caller rendering many
    batches of one pose packs it once and passes it as ``packed_camera=``
    (``RayTracer`` does)."""
    return _pack_camera(cam).to(device).contiguous()


def _check_camera(packed: torch.Tensor, device) -> torch.Tensor:
    """Raise unless ``packed`` is a packed camera the kernels can read on
    ``device``; returns it."""
    if (packed.shape != (16,) or packed.dtype != torch.float32
            or not packed.is_contiguous() or packed.device != device):
        raise ValueError(
            f"packed_camera must be pack_camera(cam, {device}): (16,) "
            f"contiguous float32, got {packed.dtype} {tuple(packed.shape)} "
            f"on {packed.device}")
    return packed


def _pack_tris(mesh, n_tri_active):
    """The kernel's (n_tris, 21) f32 triangle table: v0, e1, e2, the face
    normal, albedo, metallic, roughness, emission, ior, for the first
    ``n_tri_active`` rows (default: the whole bucket); None without a
    mesh. Padding rows have zero edges, so no ray ever hits them."""
    if mesh is None:
        return None
    n_tris = (mesh.capacity if n_tri_active is None
              else max(1, int(n_tri_active)))
    if n_tris > min(MAX_TRIS, mesh.capacity):
        raise ValueError(f"n_tri_active={n_tris} exceeds the mesh bucket "
                         f"({mesh.capacity}) or the kernel's {MAX_TRIS}")
    return torch.cat([mesh.v0, mesh.e1, mesh.e2, mesh.normal, mesh.albedo,
                      mesh.metallic[:, None], mesh.roughness[:, None],
                      mesh.emission, mesh.ior[:, None]], dim=-1)[:n_tris].to(
                          torch.float32).contiguous()


def light_cdf(scene: SphereScene) -> torch.Tensor:
    """The megakernel's NEE light pick, (capacity + 1,) f32 on the scene's
    device: the uniform cdf over the bucket's emissive spheres (valid, max
    emission > 0, radius > 0) row by row, then their count, as
    ``tpu_rt/ops/pallas_megakernel.py:878-887`` computes them. The cdf
    rides attribute column 15 and the count a 4th background word. Build
    it once per scene (``RayTracer`` does, at ``set_scene``)."""
    em_max = scene.emission.amax(dim=-1)
    is_light = scene.valid & (em_max > 0.0) & (scene.radius > 0.0)
    lw = is_light.to(torch.float32)
    n_lights = lw.sum()
    cdf = torch.cumsum(lw, 0) / torch.clamp_min(n_lights, 1.0)
    return torch.cat([cdf, n_lights[None]])


def band(width, height, rows, row_offset):
    """Validate a band of ``rows`` image rows from global row
    ``row_offset`` (None: the whole frame); returns (rows, row_offset)."""
    out_rows = height if rows is None else int(rows)
    row_offset = int(row_offset)
    if out_rows < 1 or row_offset < 0 or row_offset + out_rows > height:
        raise ValueError(f"band rows={rows}, row_offset={row_offset} does "
                         f"not lie in the frame's {height} rows")
    return out_rows, row_offset


def tile_mask_on(tile_mask, n_tiles, device):
    """The per-tile render mask as a contiguous (n_tiles,) int32 tensor on
    ``device`` (one copy from the host or another device, as the JAX
    package's), or None without one. Raises unless it has n_tiles
    elements."""
    if tile_mask is None:
        return None
    if not torch.is_tensor(tile_mask) or tile_mask.device.type == "cpu":
        profiling.count("uploads")
    mask = torch.as_tensor(tile_mask, dtype=torch.int32, device=device)
    if mask.numel() != n_tiles:
        raise ValueError(f"tile_mask has {mask.numel()} elements; this "
                         f"render has {n_tiles} tiles")
    return mask.reshape(n_tiles).contiguous()


class SceneTables(NamedTuple):
    """The megakernel's inputs that depend on the scene alone
    (:func:`scene_tables`), each f32 and contiguous on the scene's device.

    attr:        (n_spheres, 16) attribute table (:func:`attribute_matrix`
                 of the first n_spheres rows; with NEE the light cdf in
                 column 15)
    background:  (3,), or with NEE (4,): the light count appended
    tris:        (n_tris, 21) triangle table (:func:`_pack_tris`), or None
                 without a mesh
    """

    attr: torch.Tensor
    background: torch.Tensor
    tris: torch.Tensor | None


def _n_spheres(scene: SphereScene, n_active) -> int:
    n_spheres = scene.capacity if n_active is None else max(1, int(n_active))
    if n_spheres > min(MAX_SPHERES, scene.capacity):
        raise ValueError(f"n_active={n_spheres} exceeds the scene bucket "
                         f"({scene.capacity}) or the kernel's {MAX_SPHERES}")
    return n_spheres


def scene_tables(scene: SphereScene, n_active: int | None = None, *,
                 nee: bool = False, lights: torch.Tensor | None = None,
                 mesh=None, n_tri_active: int | None = None) -> SceneTables:
    """The kernel's scene inputs of the first ``n_active`` spheres (default:
    the whole bucket): with ``nee``, the light cdf (``lights``, else built
    here) in attribute column 15 and the light count as a 4th background
    word; with a ``mesh``, its first ``n_tri_active`` triangles. A caller
    rendering many batches of one scene builds them once and passes them
    as ``tables=`` (``RayTracer`` does, per scene, mesh and NEE flag)."""
    n_spheres = _n_spheres(scene, n_active)
    dev = scene.device
    cdf = None
    bg = scene.background
    if nee:
        if lights is None:
            lights = light_cdf(scene)
        if lights.shape != (scene.capacity + 1,) or lights.device != dev:
            raise ValueError(
                f"lights must be light_cdf(scene): ({scene.capacity + 1},) "
                f"on {dev}, got {tuple(lights.shape)} on {lights.device}")
        cdf = lights[:-1]
        bg = torch.cat([bg, lights[-1:]])
    tris = _pack_tris(mesh, n_tri_active)
    if tris is not None and tris.device != dev:
        raise ValueError(f"the mesh lies on {tris.device}, the scene on "
                         f"{dev}")
    # the kernel reads f32, contiguous, on the scene's device
    attr = attribute_matrix(scene, cdf)[:n_spheres].to(
        torch.float32).contiguous()
    return SceneTables(attr, bg.to(torch.float32).contiguous(), tris)


def _check_tables(tables, scene: SphereScene, n_active, nee, mesh):
    """Raise unless ``tables`` are :func:`scene_tables` of a scene like
    ``scene`` with this sphere count, NEE flag and mesh or none."""
    if not isinstance(tables, SceneTables):
        raise TypeError(f"tables must be the megakernel's SceneTables, got "
                        f"{type(tables).__name__}")
    want = ((_n_spheres(scene, n_active), 16), (4,) if nee else (3,))
    if ((tables.attr.shape, tables.background.shape) != want
            or (tables.tris is None) != (mesh is None)
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   or t.device != scene.device
                   for t in tables if t is not None)):
        raise ValueError(
            f"tables do not fit this call: attr {tuple(tables.attr.shape)} "
            f"and background {tuple(tables.background.shape)} (want "
            f"{want}), {'a' if tables.tris is not None else 'no'} triangle "
            f"table for {'a' if mesh is not None else 'no'} mesh, on "
            f"{tables.attr.device} (scene on {scene.device})")


def _prepare(scene: SphereScene, cam: CameraP, n_active, width, height,
             spp, max_depth, rows, row_offset, nee=False, lights=None,
             tile_mask=None, mesh=None, n_tri_active=None, tables=None,
             packed_camera=None):
    """Validate a call and gather the kernel's inputs on the scene's
    device: ``tables`` (:func:`scene_tables`, else built here from
    ``lights`` and the mesh) and ``packed_camera`` (:func:`pack_camera`,
    else packed here). Returns (tables, camera, band rows, row offset,
    n_tiles, mask or None)."""
    for name, val in (("width", width), ("height", height), ("spp", spp),
                      ("max_depth", max_depth)):
        if int(val) < 1:
            raise ValueError(f"{name} must be >= 1, got {val}")
    out_rows, row_offset = band(width, height, rows, row_offset)
    dev = scene.device
    if tables is None:
        tables = scene_tables(scene, n_active, nee=nee, lights=lights,
                              mesh=mesh, n_tri_active=n_tri_active)
    else:
        _check_tables(tables, scene, n_active, nee, mesh)
    packed_camera = (pack_camera(cam, dev) if packed_camera is None
                     else _check_camera(packed_camera, dev))
    n_tiles = -(-width * out_rows // TILE)
    mask = tile_mask_on(tile_mask, n_tiles, dev)
    return tables, packed_camera, out_rows, row_offset, n_tiles, mask


def _finish(img, segs, n_pix, n_tiles, with_stats):
    """Optionally add the segment count over real pixels: padding lanes
    trace too, so the total is scaled by n_pix / (n_tiles * TILE) as in the
    JAX package (exact when n_pix is a multiple of TILE)."""
    if not with_stats:
        return img
    total = segs.sum(dtype=torch.int32).to(torch.float32)
    scale = _f32(n_pix / (n_tiles * TILE))
    return img, (total * scale).to(torch.int32)


def _with_visits(result, vis):
    """``result`` (an image, or an image and a segment count) with the
    visit counts appended when there are any."""
    if vis is None:
        return result
    return (*result, vis) if isinstance(result, tuple) else (result, vis)


def _normalize3(x, y, z):
    inv = vm.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def pick_light(cdf, values, u):
    """The NEE light pick: for each draw ``u``, the row of ``values``
    ((M, 7): centre, radius, emission) whose entry of the nondecreasing
    ``cdf`` (M,) is the first to reach it, which is the number of entries
    below it; zeros where none does (the kernels' scan over the rows).
    Returns the 7 planes."""
    idx = (cdf[None, :] < u[:, None]).sum(dim=1)
    table = torch.cat([values, values.new_zeros((1, values.shape[1]))])
    return table[idx].unbind(1)


class NeePlain:
    """What the plain versions' NEE needs of an engine: the light count
    ``n_lights`` (0-dim), ``pick(u)`` (:func:`pick_light`'s planes) and
    ``occluded((hx, hy, hz), (dx, dy, dz), t_edge)`` (whether a primitive
    lies in [1e-3, t_edge) along each ray); and of one path sample
    ``no_emit`` (the lanes whose last scatter was diffuse), which
    :func:`shade_plain` reads and updates, ``diffuse``, the lanes that
    traced a shadow segment in its last call, and ``lanes``, the indices of
    the lanes whose shadow rays ``occluded`` is called with."""

    def __init__(self, n_lights, pick, occluded):
        self.n_lights = n_lights
        self.pick = pick
        self.occluded = occluded
        self.no_emit = None
        self.diffuse = None
        self.lanes = None


def shade_plain(state, best_t, w, bg, depth_idx, U, face=None,
                refract=False, nee=None, tri=None):
    """One v2 bounce of the plain versions after the nearest-hit search,
    in the JAX kernels' order of operations: background on a miss,
    emission, Russian roulette after bounce RR_START, then the metal or
    diffuse scatter from one unit-ball draw, and with ``refract`` the
    dielectric (metallic <= 0, roughness <= 0, ior > 1), which refracts or
    reflects by Schlick's probability from one more draw.

    ``state`` is (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, act);
    ``w`` the winner's (cx, cy, cz, inv_r, ar, ag, ab, met, rgh, er, eg,
    eb, ior) planes, whose normal is (hit - c) * inv_r; ``face`` optionally (is_face, nx, ny, nz): where ``is_face``,
    the normal is the face normal flipped to oppose the ray instead.
    ``U()`` draws the next salt's uniforms. With ``nee`` (a
    :class:`NeePlain`; ``tri`` marks triangle winners, or None) the bounce
    is the NEE one (pallas_megakernel.py:403-424, 467-479, 525-675): a hit
    after a diffuse scatter adds no emission unless a triangle won or the
    ray starts inside the winning sphere; diffuse lanes take the cosine
    sampler, draw a light, its cone and a shadow ray, and add the light
    unless something occludes it. Returns the new state."""
    ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, act = state
    b_cx, b_cy, b_cz, b_ir, b_ar, b_ag, b_ab, b_met, b_rgh = w[:9]
    b_er, b_eg, b_eb = w[9:12]
    bgx, bgy, bgz = bg
    f32 = torch.float32

    hit = best_t < _T_MAX
    missf = (act & ~hit).to(f32)
    cr = cr + missf * tr * bgx
    cg = cg + missf * tg * bgy
    cb = cb + missf * tb * bgz
    act = act & hit
    if nee is not None:
        eocx, eocy, eocz = ox - b_cx, oy - b_cy, oz - b_cz
        eoc2 = eocx * eocx + eocy * eocy + eocz * eocz
        suppress = nee.no_emit & ~(eoc2 * (b_ir * b_ir) < 1.0)
        if tri is not None:
            suppress = suppress & ~tri
        emitf = (act & ~suppress).to(f32)
    else:
        emitf = act.to(f32)
    cr = cr + emitf * tr * b_er
    cg = cg + emitf * tg * b_eg
    cb = cb + emitf * tb * b_eb

    if depth_idx > RR_START:
        xi_rr = U()
        p = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)), 0.1, 0.95)
        act = act & (xi_rr < p)
        comp = torch.where(act, 1.0 / p, 1.0)
        tr, tg, tb = tr * comp, tg * comp, tb * comp

    hx, hy, hz = ox + dx * best_t, oy + dy * best_t, oz + dz * best_t
    nx = (hx - b_cx) * b_ir
    ny = (hy - b_cy) * b_ir
    nz = (hz - b_cz) * b_ir
    if face is not None:
        is_face, tnx, tny, tnz = face
        tsgn = torch.where(dx * tnx + dy * tny + dz * tnz < 0.0, 1.0, -1.0)
        nx = torch.where(is_face, tnx * tsgn, nx)
        ny = torch.where(is_face, tny * tsgn, ny)
        nz = torch.where(is_face, tnz * tsgn, nz)

    # uniform point in the unit ball: direction x cbrt radius
    u1, u2, u3 = U(), U(), U()
    z = 1.0 - 2.0 * u1
    r_xy = vm.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = _TWO_PI * u2
    r = torch.exp(torch.log(torch.clamp_min(u3, 1e-12)) * _THIRD)
    bx = r_xy * torch.cos(phi) * r
    by = r_xy * torch.sin(phi) * r
    bz = z * r

    d_dot_n = dx * nx + dy * ny + dz * nz
    mx, my, mz = _normalize3(dx - 2.0 * d_dot_n * nx + bx * b_rgh,
                             dy - 2.0 * d_dot_n * ny + by * b_rgh,
                             dz - 2.0 * d_dot_n * nz + bz * b_rgh)
    if nee is not None:
        # the exact cosine sampler: normal + unit-sphere direction
        sx, sy, sz = _normalize3(bx, by, bz)
        cdx, cdy, cdz = nx + sx, ny + sy, nz + sz
        l2 = cdx * cdx + cdy * cdy + cdz * cdz
        deg = l2 < 1e-12
        inv = vm.rsqrt(torch.clamp_min(l2, 1e-20))
        fx = torch.where(deg, nx, cdx * inv)
        fy = torch.where(deg, ny, cdy * inv)
        fz = torch.where(deg, nz, cdz * inv)
    else:
        sgn = torch.where(bx * nx + by * ny + bz * nz > 0.0, 1.0, -1.0)
        fx, fy, fz = _normalize3(nx + bx * sgn, ny + by * sgn,
                                 nz + bz * sgn)
    is_metal = b_met > 0.0
    is_spec = is_metal
    ndx = torch.where(is_metal, mx, fx)
    ndy = torch.where(is_metal, my, fy)
    ndz = torch.where(is_metal, mz, fz)

    if refract:
        b_ior = w[12]
        front = dx * nx + dy * ny + dz * nz < 0.0
        sgn_n = torch.where(front, 1.0, -1.0)
        nex, ney, nez = nx * sgn_n, ny * sgn_n, nz * sgn_n
        eta = torch.where(front, 1.0 / b_ior, b_ior)
        dt = dx * nex + dy * ney + dz * nez
        disc = 1.0 - eta * eta * (1.0 - dt * dt)
        sq = vm.sqrt(torch.clamp_min(disc, 0.0))
        cosine = torch.clamp_max(-dt, 1.0)
        r0 = (1.0 - b_ior) / (1.0 + b_ior)
        r0 = r0 * r0
        omc = 1.0 - cosine
        omc2 = omc * omc
        schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
        use_refl = U() < torch.where(disc > 0.0, schlick, 1.0)
        gx, gy, gz = _normalize3(
            torch.where(use_refl, dx - 2.0 * dt * nex,
                        (dx - nex * dt) * eta - nex * sq),
            torch.where(use_refl, dy - 2.0 * dt * ney,
                        (dy - ney * dt) * eta - ney * sq),
            torch.where(use_refl, dz - 2.0 * dt * nez,
                        (dz - nez * dt) * eta - nez * sq))
        is_glass = (b_met <= 0.0) & (b_rgh <= 0.0) & (b_ior > 1.0)
        ndx = torch.where(is_glass, gx, ndx)
        ndy = torch.where(is_glass, gy, ndy)
        ndz = torch.where(is_glass, gz, ndz)
        is_spec = is_spec | is_glass

    if nee is not None:
        cr, cg, cb = _direct_light(nee, act & ~is_spec, (hx, hy, hz),
                                   (nx, ny, nz), (tr, tg, tb), w[4:7],
                                   (cr, cg, cb), U)

    tr, tg, tb = tr * b_ar, tg * b_ag, tb * b_ab
    ox = torch.where(act, hx, ox)
    oy = torch.where(act, hy, oy)
    oz = torch.where(act, hz, oz)
    dx = torch.where(act, ndx, dx)
    dy = torch.where(act, ndy, dy)
    dz = torch.where(act, ndz, dz)
    return ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb, act


def _direct_light(nee, diffuse, h, n, thr, albedo, col, U):
    """NEE's shadow ray from the ``diffuse`` lanes (pallas_megakernel.py:
    536-675): the light pick and two cone draws (drawn for every lane),
    the direction in the cone the picked light subtends, the light's entry
    t, and, where the light is in front of the surface, does not enclose
    the hit and nothing occludes it, the gathered radiance col + thr *
    albedo * cos * weight * n_lights / pi * Le. Sets ``nee.no_emit`` and
    ``nee.diffuse`` to the diffuse lanes. Returns the new (cr, cg, cb)."""
    hx, hy, hz = h
    nx, ny, nz = n
    l_cx, l_cy, l_cz, l_r, l_er, l_eg, l_eb = nee.pick(U())
    tlx, tly, tlz = l_cx - hx, l_cy - hy, l_cz - hz
    d2 = torch.clamp_min(tlx * tlx + tly * tly + tlz * tlz, 1e-12)
    sin2 = (l_r * l_r) / d2
    inside = sin2 >= 1.0
    cos_max = vm.sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
    xi1, xi2 = U(), U()
    cos_t = 1.0 - xi1 * (1.0 - cos_max)
    sin_t = vm.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi_l = _TWO_PI * xi2
    inv_dl = vm.rsqrt(d2)
    wx, wy, wz = tlx * inv_dl, tly * inv_dl, tlz * inv_dl
    # orthonormal basis around w (branchless axis pick)
    big = torch.abs(wx) > 0.9
    ax = torch.where(big, 0.0, 1.0)
    ay = torch.where(big, 1.0, 0.0)
    t1x, t1y, t1z = _normalize3(ay * wz, -ax * wz, ax * wy - ay * wx)
    t2x = wy * t1z - wz * t1y
    t2y = wz * t1x - wx * t1z
    t2z = wx * t1y - wy * t1x
    sc = sin_t * torch.cos(phi_l)
    ss = sin_t * torch.sin(phi_l)
    ldx = wx * cos_t + t1x * sc + t2x * ss
    ldy = wy * cos_t + t1y * sc + t2y * ss
    ldz = wz * cos_t + t1z * sc + t2z * ss
    weight = _TWO_PI * (1.0 - cos_max)  # 1 / pdf(omega)
    # t to the light's entry along the shadow ray
    lox, loy, loz = hx - l_cx, hy - l_cy, hz - l_cz
    lhb = lox * ldx + loy * ldy + loz * ldz
    lcq = lox * lox + loy * loy + loz * loz - l_r * l_r
    ldisc = lhb * lhb - lcq
    lsq = vm.sqrt(torch.clamp_min(ldisc, 0.0))
    lt0 = -lhb - lsq
    lt1 = -lhb + lsq
    t_light = torch.where(lt0 >= 1e-3, lt0, lt1)
    light_ok = (ldisc >= 0.0) & (t_light >= 1e-3)
    t_edge = t_light - 1e-3
    ndl = nx * ldx + ny * ldy + nz * ldz
    gate = (diffuse & light_ok & ~inside & (ndl > 0.0)
            & (nee.n_lights > 0.0))
    # only the gated lanes trace their shadow ray (the others' result is
    # unused): the lanes are independent, so the subset changes no value
    idx = gate.nonzero()[:, 0]
    nee.lanes = idx  # which lanes trace, for a caller that counts them
    occ = nee.occluded((hx[idx], hy[idx], hz[idx]),
                       (ldx[idx], ldy[idx], ldz[idx]), t_edge[idx])
    gate = gate.index_put((idx,), ~occ)
    scale = gate.to(torch.float32) * ndl * weight * (nee.n_lights * _INV_PI)
    (tr, tg, tb), (ar, ag, ab), (cr, cg, cb) = thr, albedo, col
    nee.no_emit = nee.diffuse = diffuse
    return (cr + tr * ar * scale * l_er, cg + tg * ag * scale * l_eg,
            cb + tb * ab * scale * l_eb)


def stratify_shift(flat, seed):
    """The per-pixel Cranley-Patterson shift of the R2 lattice: salts 9001
    and 9002 of the stream ``seed`` (the per-tile seed without the sample
    term, so every sample of a frame shares it)."""
    mix = flat ^ _mul32(seed & _M32, _C_SEED)
    return _uniform_from_mix(mix, 9001), _uniform_from_mix(mix, 9002)


def primary_rays(cam, px, py, inv_w, inv_h, s, U, *, jitter, dof,
                 shift=None):
    """The primary rays of sample ``s`` in the JAX kernels' order of
    operations: the pixel offset (with ``shift``, the R2 lattice point
    frac(shift + s * alpha); else ``U()`` jitter or the centre), the
    pinhole direction, then with ``dof`` the thin lens, whose two draws
    follow. ``cam`` is the packed (16,) camera. Returns (ox, oy, oz, dx,
    dy, dz)."""
    (cpx, cpy, cpz, fwx, fwy, fwz, rix, riy, riz, upx, upy, upz,
     tf_aspect, tf, ap, fo) = cam.unbind(0)
    n = px.shape[0]
    if shift is not None:
        xu = shift[0] + _f32(np.float32(s) * np.float32(R2_ALPHA_U))
        xu = xu - torch.floor(xu)
        xv = shift[1] + _f32(np.float32(s) * np.float32(R2_ALPHA_V))
        xv = xv - torch.floor(xv)
    elif jitter:
        xu = U()
        xv = U()
    else:
        xu = xv = 0.5
    u = (px + xu) * inv_w
    v = (py + xv) * inv_h
    vx = (u - 0.5) * 2.0 * tf_aspect
    vy = (0.5 - v) * 2.0 * tf
    dx, dy, dz = _normalize3(fwx + rix * vx + upx * vy,
                             fwy + riy * vx + upy * vy,
                             fwz + riz * vx + upz * vy)
    ox, oy, oz = cpx.expand(n), cpy.expand(n), cpz.expand(n)
    if dof:
        tfoc = fo / torch.clamp_min(dx * fwx + dy * fwy + dz * fwz, 1e-6)
        fpx, fpy, fpz = ox + dx * tfoc, oy + dy * tfoc, oz + dz * tfoc
        r_l = ap * vm.sqrt(U())
        ph = _TWO_PI * U()
        lx = r_l * torch.cos(ph)
        ly = r_l * torch.sin(ph)
        ox = ox + rix * lx + upx * ly
        oy = oy + riy * lx + upy * ly
        oz = oz + riz * lx + upz * ly
        dx, dy, dz = _normalize3(fpx - ox, fpy - oy, fpz - oz)
    return ox, oy, oz, dx, dy, dz


def mt_test(o, d, v0, e1, e2):
    """Scalar Moller-Trumbore in the JAX kernels' order of operations:
    (hit, t) of rays ``o + t d`` against triangles (v0, e1, e2), each a
    triple of broadcastable tensors. A determinant of at most 1e-9 (zero
    edges: padding) never hits."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    okd = torch.abs(det) > 1e-9
    inv = 1.0 / torch.where(okd, det, 1.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = (okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt >= 1e-3))
    return ok, tt


def _shadow_sweep(rows, tri_rows, o, d, t_edge):
    """The kernel's shadow sweep (``MegaNee::occluded``,
    pallas_megakernel.py:613-657): whether a sphere row (attribute planes:
    centre 0-2, radius 3, inv_r 14; the NaN-propagating root select) or a
    triangle row of ``tri_rows`` has a root or t in [1e-3, t_edge) along
    (o, d), with the sphere and triangle tests the kernel runs for each
    ray: spheres, then triangles, up to the first blocker. Returns
    (occluded, sphere tests, triangle tests)."""
    (ox, oy, oz), (dx, dy, dz) = o, d
    occ = torch.zeros_like(t_edge, dtype=torch.bool)
    n_sph = torch.zeros_like(t_edge, dtype=torch.int64)
    for a in rows:
        n_sph += ~occ
        ocx, ocy, ocz = ox - a[0], oy - a[1], oz - a[2]
        half_b = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - a[3] * a[3]
        sqrtd = vm.sqrt(half_b * half_b - cq)
        root0 = -half_b - sqrtd
        root = torch.where(root0 >= 1e-3, root0, sqrtd - half_b)
        occ = occ | ((root >= 1e-3) & (root < t_edge) & (a[14] > 0.0))
    n_tri = torch.zeros_like(n_sph)
    for g in tri_rows:
        n_tri += ~occ
        ok, tt = mt_test(o, d, g[0:3], g[3:6], g[6:9])
        occ = occ | (ok & (tt < t_edge))
    return occ, n_sph, n_tri


def _output(acc, inv_spp, gamma):
    """The spp mean of each channel: sqrt gamma and clamp, or linear."""
    if gamma:
        acc = [torch.clamp(vm.sqrt(torch.clamp_min(a * inv_spp, 0.0)),
                           0.0, 1.0) for a in acc]
    else:
        acc = [a * inv_spp for a in acc]
    return torch.stack(acc, dim=-1)


def _trace_plain(attr, tris, cam, bg, seed, width, height, spp, max_depth,
                 jitter, n_tiles, refract=False, dof=False, stratify=False,
                 nee=False, gamma=True, out_rows=None, row_offset=0,
                 mask=None, visits=False):
    """The kernel's computation as whole-tensor PyTorch ops over every lane
    of every tile, in the JAX kernel's order of operations: the spheres,
    then the triangles of ``tris`` (or None), one row at a time. With
    ``nee``, attribute column 15 holds the light cdf and ``bg`` (4,) ends
    with the light count. A band (``out_rows`` rows from ``row_offset``)
    offsets the hash's pixel id and the pixel coordinates by
    ``row_offset * width``; the tile seed stays the band's own. Every tile
    is traced; those whose ``mask`` entry is 0 are zeroed afterwards, pixels
    and segment count (streams do not depend on the mask).

    Returns ((n_pix, 3) f32 image, (n_tiles,) int32 segment counts, and
    with ``visits`` the (n_tiles, 2, 4) int64 counts of :data:`VISIT_COLS`
    for path and shadow rays, whose warp column is -1 (the kernel's alone),
    else None)."""
    dev = attr.device
    f32 = torch.float32
    n = n_tiles * TILE
    out_rows = height if out_rows is None else out_rows
    local = torch.arange(n, dtype=torch.int64, device=dev)
    tile = local // TILE
    flat = local + row_offset * width
    px = (flat % width).to(f32)
    py = (flat // width).to(f32)
    inv_w = _f32(1.0 / width)
    inv_h = _f32(1.0 / height)
    bgx, bgy, bgz = bg[:3].unbind(0)
    rows = [attr[i].unbind(0) for i in range(attr.shape[0])]
    tri_rows = [] if tris is None else [t.unbind(0) for t in tris]
    tile_seed = (tile + (int(seed) & _M32)) & _M32
    # the R2 shift (stratify shoots pixel centres without jitter): keyed by
    # the per-tile seed, drawn once for all samples
    shift = stratify_shift(flat, tile_seed) if stratify and jitter else None
    # the winner planes: cx cy cz inv_r ar ag ab met rgh er eg eb ior
    cols = (0, 1, 2, 14, 4, 5, 6, 7, 8, 9, 10, 11, 12)
    tcols = tuple(range(12, 21))
    light = None
    vis = torch.zeros((n_tiles, 2, len(VISIT_COLS)), dtype=torch.int64,
                      device=dev)
    if nee:
        def occluded(o, d, t_edge):
            occ, n_sph, n_tri = _shadow_sweep(rows, tri_rows, o, d, t_edge)
            if visits:
                at = light.lanes // TILE
                vis[:, 1, 1].index_add_(0, at, n_sph)
                vis[:, 1, 2].index_add_(0, at, n_tri)
            return occ

        light = NeePlain(bg[3], lambda u: pick_light(
            attr[:, 15], attr[:, [0, 1, 2, 3, 9, 10, 11]], u), occluded)

    acc = [torch.zeros(n, dtype=f32, device=dev) for _ in range(3)]
    segs = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    for s in range(spp):
        mix = flat ^ _mul32((tile_seed + s * 7919) & _M32, _C_SEED)
        salt = 0

        def U():
            # the JAX kernel's salt: a counter over its unrolled call sites
            nonlocal salt
            salt += 1
            return _uniform_from_mix(mix, salt)

        ox, oy, oz, dx, dy, dz = primary_rays(
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
            live = act.view(n_tiles, TILE).sum(1, dtype=torch.int32)
            segs += live
            if visits:  # each live path sweeps every row
                vis[:, 0] += live[:, None].long() * torch.tensor(
                    [1, len(rows), len(tri_rows), 0], device=dev)

            best_t = torch.full((n,), _T_MAX, dtype=f32, device=dev)
            zero = torch.zeros(n, dtype=f32, device=dev)
            # the JAX kernel's initial planes: zeros, and ior 1
            b = [zero] * 12 + [torch.ones_like(zero)]
            for a in rows:
                ocx, ocy, ocz = ox - a[0], oy - a[1], oz - a[2]
                half_b = ocx * dx + ocy * dy + ocz * dz
                cq = (ocx * ocx + ocy * ocy + ocz * ocz) - a[3] * a[3]
                # sqrt of a negative discriminant is NaN: every compare on
                # it is False, so misses fall out without a disc >= 0 test
                sqrtd = vm.sqrt(half_b * half_b - cq)
                root0 = -half_b - sqrtd
                root = torch.where(root0 >= 1e-3, root0, sqrtd - half_b)
                better = (root >= 1e-3) & (root < best_t) & (a[14] > 0.0)
                best_t = torch.where(better, root, best_t)
                b = [torch.where(better, a[c], bc) for c, bc in zip(cols, b)]

            face = None
            if tri_rows:
                # a triangle winner keeps the sphere planes' centre and
                # 1/r; its face normal rides beside them
                face = [torch.zeros(n, dtype=torch.bool, device=dev),
                        zero, zero, zero]
            for g in tri_rows:
                ok, tt = mt_test((ox, oy, oz), (dx, dy, dz), g[0:3], g[3:6],
                                 g[6:9])
                better = ok & (tt < best_t)
                best_t = torch.where(better, tt, best_t)
                face = [face[0] | better] + [
                    torch.where(better, g[c], fc)
                    for c, fc in zip((9, 10, 11), face[1:])]
                b = b[:4] + [torch.where(better, g[c], bc) for c, bc in
                             zip(tcols, b[4:])]

            (ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg, cb,
             act) = shade_plain((ox, oy, oz, dx, dy, dz, tr, tg, tb, cr, cg,
                                 cb, act), best_t, b, (bgx, bgy, bgz),
                                depth_idx, U, face, refract, light,
                                None if face is None else face[0])
            if light is not None:  # one shadow segment per diffuse lane
                shadow = light.diffuse.view(n_tiles, TILE).sum(
                    1, dtype=torch.int32)
                segs += shadow
                vis[:, 1, 0] += shadow

        acc = [acc[0] + cr, acc[1] + cg, acc[2] + cb]

    img = _output(acc, _f32(1.0 / spp), gamma)
    if mask is not None:
        on = mask != 0
        img = torch.where(on[tile, None], img, 0.0)
        segs = torch.where(on, segs, 0)
        vis = torch.where(on[:, None, None], vis, 0)
    vis[..., 3] = -1
    return img[:width * out_rows], segs, vis if visits else None


def render_megakernel_reference(
    scene: SphereScene,
    cam: CameraP,
    seed: int,
    *,
    width: int = 1920,
    height: int = 1080,
    spp: int = 4,
    max_depth: int = 4,
    jitter: bool = True,
    n_active: int | None = None,
    with_stats: bool = False,
    rows: int | None = None,
    row_offset: int = 0,
    mesh=None,
    n_tri_active: int | None = None,
    enable_refraction: bool = False,
    enable_dof: bool = False,
    stratify: bool = False,
    nee: bool = False,
    gamma: bool = True,
    lights: torch.Tensor | None = None,
    tile_mask=None,
    with_visits: bool = False,
    tables: SceneTables | None = None,
    packed_camera: torch.Tensor | None = None,
):
    """The plain PyTorch version of the megakernel, on any device.

    Same contract as :func:`render_megakernel`: (rows, width, 3) f32 in
    [0, 1] (the linear mean with ``gamma=False``), plus the real-pixel
    segment count when ``with_stats``, plus with ``with_visits`` the
    counts of :func:`megakernel_visits_reference`."""
    tables, cam_packed, out_rows, row_offset, n_tiles, mask = _prepare(
        scene, cam, n_active, width, height, spp, max_depth, rows, row_offset,
        nee, lights, tile_mask, mesh, n_tri_active, tables, packed_camera)
    img, segs, vis = _trace_plain(
        tables.attr, tables.tris, cam_packed, tables.background, seed, width,
        height, spp, max_depth, jitter, n_tiles, bool(enable_refraction),
        bool(enable_dof), bool(stratify), bool(nee), bool(gamma), out_rows,
        row_offset, mask, bool(with_visits))
    return _with_visits(_finish(img.reshape(out_rows, width, 3), segs,
                                width * out_rows, n_tiles, with_stats), vis)


def megakernel_visits_reference(scene: SphereScene, cam: CameraP, seed: int,
                                **kw) -> torch.Tensor:
    """What the megakernel's rays test, emulated by the plain version over
    the same rays (the keywords of :func:`render_megakernel`): per 4096-ray
    tile, for path and then shadow rays, the :data:`VISIT_COLS` counts as
    (n_tiles, 2, 4) int64: segments (path and shadow segments sum to the
    tile's segment count), sphere and triangle tests (every path segment
    sweeps every row; a traced shadow ray sweeps the spheres, then the
    triangles, up to its first blocker), and -1 for the tests the warps
    issued, which only the kernel's counting instantiation counts. Zeros
    for a masked tile."""
    kw = dict(kw, with_stats=False, with_visits=True)
    return render_megakernel_reference(scene, cam, seed, **kw)[1]


def _signed32(x: int) -> int:
    x = int(x) & _M32
    return x - (1 << 32) if x >= 1 << 31 else x


def render_megakernel(
    scene: SphereScene,
    cam: CameraP,
    seed: int,
    *,
    width: int = 1920,
    height: int = 1080,
    spp: int = 4,
    max_depth: int = 4,
    jitter: bool = True,
    n_active: int | None = None,
    with_stats: bool = False,
    rows: int | None = None,
    row_offset: int = 0,
    mesh=None,
    n_tri_active: int | None = None,
    enable_refraction: bool = False,
    enable_dof: bool = False,
    stratify: bool = False,
    nee: bool = False,
    gamma: bool = True,
    lights: torch.Tensor | None = None,
    tile_mask=None,
    with_visits: bool = False,
    tables: SceneTables | None = None,
    packed_camera: torch.Tensor | None = None,
):
    """Render one batch of ``spp`` samples through the megakernel.

    Returns (height, width, 3) f32 in [0, 1] (with ``gamma=False`` the
    linear mean, unclamped), and with ``with_stats`` also the traced
    segment count over real pixels (an int32 0-dim tensor).
    ``seed`` is an int taken modulo 2^32 (int32 wrap, as in the JAX
    package); ``n_active`` the number of leading scene rows to sweep
    (default: the whole bucket). ``mesh`` adds a TriangleMesh on the
    scene's device, of which the first ``n_tri_active`` rows (default: the
    whole bucket, at most 256) are swept after the spheres.
    ``enable_refraction`` turns materials with metallic <= 0, roughness <= 0
    and ior > 1 into glass; ``enable_dof`` traces the camera's thin lens
    (``cam.aperture``, ``cam.focus_dist``); ``stratify`` (with ``jitter``)
    places a pixel's samples on the R2 lattice under a per-pixel shift.
    ``nee`` adds next-event estimation towards the scene's emissive
    spheres, whose light cdf ``lights`` (:func:`light_cdf`, built here when
    None) a caller rendering many frames builds once; each shadow ray
    counts as one more segment.

    ``tables`` (:func:`scene_tables` of this scene, sphere count, NEE flag
    and mesh; then ``lights`` is not read) and ``packed_camera``
    (:func:`pack_camera` of ``cam``) pass the kernel's inputs built once
    per scene and per pose; without them each call builds its own.

    ``rows``/``row_offset`` render the band of ``rows`` image rows from
    global row ``row_offset`` as a (rows, width, 3) image, as
    ``render_pallas`` does: the hash's pixel ids and the camera's
    coordinates are the full frame's, the per-tile seed the band's own
    tile index. ``tile_mask`` (adaptive sampling): one int per
    4096-pixel tile of the render (a tensor on any device, or a numpy
    array; copied to the scene's device); a tile with 0 is skipped and
    returns zeros and no segments, every other tile the unmasked render's
    values.

    ``with_visits`` runs the kernel's counting instantiation and appends
    the (n_tiles, 2, 4) int64 counts of :data:`VISIT_COLS` per tile, for
    path and then shadow rays (segments, sphere tests, triangle tests, the
    tests the warps issued); the image and segments, from the counting
    instantiation, equal the timed one's. On the CPU the counts are
    :func:`megakernel_visits_reference`'s.

    A scene on the CPU runs the plain version; a scene on a CUDA device
    launches the CUDA kernel (built on first use) and raises if the launch
    fails. ``render_megakernel.launches`` counts kernel launches.
    """
    dev = scene.device
    if dev.type == "cpu":
        return render_megakernel_reference(
            scene, cam, seed, width=width, height=height, spp=spp,
            max_depth=max_depth, jitter=jitter, n_active=n_active,
            with_stats=with_stats, rows=rows, row_offset=row_offset,
            mesh=mesh, n_tri_active=n_tri_active,
            enable_refraction=enable_refraction, enable_dof=enable_dof,
            stratify=stratify, nee=nee, gamma=gamma, lights=lights,
            tile_mask=tile_mask, with_visits=with_visits, tables=tables,
            packed_camera=packed_camera)
    if dev.type != "cuda":
        raise ValueError(f"render_megakernel runs on cpu or cuda, not {dev}")

    with torch.cuda.device(dev):
        with profiling.span("prepare"):
            tables, cam_packed, out_rows, row_offset, n_tiles, mask = (
                _prepare(scene, cam, n_active, width, height, spp, max_depth,
                         rows, row_offset, nee, lights, tile_mask, mesh,
                         n_tri_active, tables, packed_camera))
            attr, bg, tris = tables
            lib = build.load()
            n_pix = width * out_rows
            out = torch.empty((out_rows, width, 3), dtype=torch.float32,
                              device=dev)
            segs = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
            vis = (torch.zeros((n_tiles, 2, len(VISIT_COLS)),
                               dtype=torch.int64, device=dev)
                   if with_visits else None)
            stream = torch.cuda.current_stream(dev).cuda_stream
        with profiling.span("launch"):
            err = lib.tpurt_megakernel_launch(
                attr.data_ptr(), attr.shape[0],
                0 if tris is None else tris.data_ptr(),
                0 if tris is None else tris.shape[0], cam_packed.data_ptr(),
                bg.data_ptr(), _signed32(seed), row_offset * width, width,
                height, spp, max_depth, int(bool(jitter)),
                int(bool(enable_refraction)), int(bool(enable_dof)),
                int(bool(stratify)), int(bool(nee)), int(bool(gamma)),
                n_tiles, 0 if mask is None else mask.data_ptr(),
                out.data_ptr(), n_pix, segs.data_ptr(),
                0 if vis is None else vis.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
    render_megakernel.launches += 1
    return _with_visits(_finish(out, segs, n_pix, n_tiles, with_stats), vis)


render_megakernel.launches = 0
