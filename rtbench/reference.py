"""The plain reference of the benchmark: what a progressive render must
produce, worked out again from the scene, the camera and the seeds.

Plain PyTorch. It imports nothing of the program under test: the stream
hash, the camera basis, the v2 estimator (with next-event estimation), the
nearest-hit search over spheres and triangles, the per-batch mean with
sqrt gamma, the progressive accumulation and the uint8 display stack are
written out here, in the order of operations the program documents, so
that on one device both give the same bits. The nearest-hit search is a
brute-force sweep over every sphere and triangle of the scene (``Scene``):
the program's cluster tables and their camera order are not used, and the
light tables are worked out again from the engines' documentation. Where
several primitives give the same least t, a sphere wins over a triangle,
and the first in scene order among its kind.

Two engines key the random stream differently, and the reference follows
each (``ENGINES``):

* ``pallas`` (the megakernel): tiles of 4096 pixels in scan order; sample
  ``s`` of pixel ``flat`` in tile ``t`` of batch seed ``b`` draws from
  ``flat ^ ((t + b + 7919 s) * C)``; attributes and face normals in
  float32.
* ``cluster``: screen blocks of 32 rows x 128 columns, row-major; sample
  ``s`` draws from ``flat ^ ((b + t spp + s) * C)``; the shading
  attributes (albedo, metallic, roughness, emission, ior) and the
  triangles' face normals are held as bfloat16 by the engine's tables, so
  the reference rounds them so too.

``dtype`` computes everything in another precision: the control of the
comparison runs this reference in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
C_SEED = 2654435769
C_MIX1 = 2246822507
C_MIX2 = 3266489909
RR_START = 3          # Russian roulette after this many bounces
REF_PI = 3.14159      # the reference camera's truncated pi
TILE = 4096           # pixels per megakernel tile, per cluster screen block
SUBLANES, LANES = 32, 128
ENGINES = ("pallas", "cluster")
# (ray, primitive) pairs the search tests at once
PAIRS_PER_CHUNK = 1 << 25
# at most DENSE_MAX spheres (or triangles) test every pair; more group them
# by GROUP
DENSE_MAX = 64
GROUP = 64
# |det| at or below which a ray is parallel to a triangle
DET_EPS = 1e-9
# rows of the cluster engine's NEE light table (its n_lights_max)
CLUSTER_LIGHTS = 8


def f32(x: float) -> float:
    """A Python float rounded to float32."""
    return float(np.float32(x))


TWO_PI = f32(6.2831853071795864)
THIRD = f32(1.0 / 3.0)
INV_PI = f32(0.3183098861837907)
T_MAX = f32(1e10)
T_MIN = 1e-3


# ---------------------------------------------------------------------------
# the stream: a murmur3-style counter hash on uint32 values held in int64
# ---------------------------------------------------------------------------

def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32)."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def uniform(mix: torch.Tensor, salt: int) -> torch.Tensor:
    """U[0, 1) float32 of call site ``salt`` from ``mix = flat ^ seed*C``."""
    h = (mix + salt * 40503) & M32
    h = h ^ (h >> 16)
    h = mul32(h, C_MIX1)
    h = h ^ (h >> 13)
    h = mul32(h, C_MIX2)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def batch_seed(tracer_seed: int, frame: int) -> int:
    """The stream seed of the ``frame``-th batch (counting from 0) of a
    progressive tracer created with ``tracer_seed``."""
    return ((tracer_seed + 1) * 1000003 + frame) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# vector helpers, rounded as the kernels round
# ---------------------------------------------------------------------------

def _f32_bits(x) -> torch.Tensor:
    """The bits of float32 values (a tensor in any float type, or a
    Python float) as int64."""
    x = torch.as_tensor(x).to(torch.float32)
    return x.contiguous().view(torch.int32).to(torch.int64)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (float64, rounded once)."""
    return torch.sqrt(x.double()).to(x.dtype)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / sqrt(x)


def normalize3(x, y, z):
    inv = rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _normalize(a):
    sq = _dot(a, a)[..., None]
    ok = sq > 1e-20
    out = a * rsqrt(torch.where(ok, sq, torch.ones_like(sq)))
    fallback = torch.zeros_like(out)
    fallback[..., 2] = 1.0
    return torch.where(ok, out, fallback)


def pack_camera(camera: dict, aspect: float, device, dtype=torch.float32):
    """[pos3, fwd3, right3, up3, tan(fov/2) * aspect, tan(fov/2), 0, look]
    as (16,) ``dtype`` on ``device``: the pinhole camera of ``camera``
    ({"position", "target", "up", "fov"}) at the image's aspect."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    pos, target = t(camera["position"]), t(camera["target"])
    fov, asp = t(camera["fov"]), t(aspect)
    forward = _normalize(target - pos)
    world_up = t([0.0, 1.0, 0.0])
    right_raw = _cross(forward, world_up)
    degenerate = _dot(right_raw, right_raw) < 1e-6
    right = torch.where(degenerate, t([1.0, 0.0, 0.0]), _normalize(right_raw))
    up = _normalize(_cross(right, forward))
    tf = torch.tan(fov * (REF_PI / 360.0))
    look = sqrt(_dot(target - pos, target - pos))
    return torch.cat([pos, forward, right, up,
                      torch.stack([tf * asp, tf, t(0.0), look])]).to(dtype)


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

def _face_frame(vertices):
    """(v0, e1, e2, normal), float32 (F, 3) each, of (F, 3, 3) vertices:
    the edges from the first vertex and the unit normal of e1 x e2 ((0, 0,
    1) where that is 0), in numpy, in the order of operations that the
    program's mesh builder documents (``ops/triangle.py:make_mesh``)."""
    v = np.asarray(vertices, np.float32).reshape(-1, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    nrm = np.cross(e1, e2)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-20), [0.0, 0.0, 1.0])
    return v[:, 0], e1, e2, nrm.astype(np.float32)


def _leaves(mid, idx):
    """``idx`` split at medians of ``mid`` along the widest extent, into
    groups of at most GROUP."""
    if len(idx) <= GROUP:
        return [idx]
    ext = mid[idx].max(0) - mid[idx].min(0)
    order = idx[np.argsort(mid[idx, int(np.argmax(ext))], kind="stable")]
    h = len(order) // 2
    return _leaves(mid, order[:h]) + _leaves(mid, order[h:])


def _blocks(o, d, count, groups):
    """Blocks (rays (P,), primitives (P, M), -1 for none) that hold every
    pair of a ray of (o, d) and one of ``count`` primitives it could hit:
    every pair up to DENSE_MAX primitives; past it the pairs of
    ``groups()`` (big primitives, (G, GROUP) table, group centres, radii,
    least primitive radius), where a ray tests a group only if it passes
    within the group's bounding sphere, widened by the margin."""
    n = o[0].shape[0]
    dev = o[0].device
    if not count:
        return
    if count <= DENSE_MAX:
        every = torch.arange(count, device=dev)[None, :]
        step = max(1, PAIRS_PER_CHUNK // count)
        for lo in range(0, n, step):
            rays = torch.arange(lo, min(n, lo + step), device=dev)
            yield rays, every.expand(rays.shape[0], -1)
        return
    big, table, centre, radius, r_min = groups()
    if big.numel():
        step = max(1, PAIRS_PER_CHUNK // big.numel())
        for lo in range(0, n, step):
            rays = torch.arange(lo, min(n, lo + step), device=dev)
            yield rays, big[None, :].expand(rays.shape[0], -1)
    if not table.shape[0]:
        return
    step = max(1, (PAIRS_PER_CHUNK // 8) // table.shape[0])
    for lo in range(0, n, step):
        sl = slice(lo, min(n, lo + step))
        oo = torch.stack([x[sl] for x in o], -1).double()[:, None, :]
        dd = torch.stack([x[sl] for x in d], -1).double()[:, None, :]
        oc = oo - centre[None]
        b = (oc * dd).sum(-1)
        q = (oc * oc).sum(-1)
        d2 = (dd * dd).sum(-1)
        reach = radius + 0.01 * (1.0 + torch.sqrt(q) + radius) \
            + 2e-6 * q / r_min
        near = (q - b * b / d2 <= reach * reach) & (b <= reach * d2)
        ray, grp = near.nonzero(as_tuple=True)
        per = max(1, PAIRS_PER_CHUNK // GROUP)
        for k in range(0, ray.shape[0], per):
            yield ray[k:k + per] + lo, table[grp[k:k + per]]


def _grouped(leaves, big, bounds, dev):
    """The tensors of :func:`_blocks`'s ``groups()``: ``bounds(idx)``
    gives a leaf's (centre, radius, least primitive radius)."""
    table = np.full((len(leaves), GROUP), -1, np.int64)
    centre = np.zeros((len(leaves), 3))
    radius = np.zeros(len(leaves))
    r_min = np.ones(len(leaves))
    for k, idx in enumerate(leaves):
        table[k, :len(idx)] = idx
        centre[k], radius[k], r_min[k] = bounds(idx)
    return (torch.as_tensor(np.flatnonzero(big), device=dev),
            torch.as_tensor(table, device=dev),
            torch.as_tensor(centre, device=dev),
            torch.as_tensor(radius, device=dev),
            torch.as_tensor(r_min, device=dev))


class Scene:
    """The scene as planes on one device: the spheres' centre (N, 3),
    radius and 1/r; the triangles' v0, e1, e2 and face normal (T, 3); the
    shading planes of both (albedo 3, metallic, roughness, emission 3,
    ior); the background (3,); and the engine's light table for next-event
    estimation.

    Spheres and triangles share one index: the spheres 0 .. N - 1 in scene
    order, then the triangles in mesh order. The nearest hit of a ray is
    the least (t, index): at equal t a sphere beats a triangle, as in both
    engines' plain versions, which sweep the spheres before the triangles
    and keep the first of equal t (``ops/megakernel.py:793``,
    ``ops/cluster.py:597`` and ``:613``; the cluster kernel's keys put the
    sphere classes first, ``ops/cluster.py:628``). Among spheres, or among
    triangles, the first in scene order wins: the megakernel's order; the
    cluster engine takes its table's (Morton, then camera) order instead,
    which the reference does not follow.

    Lights (spheres only; no triangle is sampled): the megakernel draws
    from a uniform cdf over every emissive sphere in scene order
    (``ops/megakernel.py:159 light_cdf``); the cluster engine from the
    first min(CLUSTER_LIGHTS, N) spheres taken emissive ones first, stable
    by index, with a uniform cdf over the lights among them and radius 0
    on the others (``ops/cluster.py:382-405 light_table``,
    ``tpu_rt/ops/pallas_cluster.py:1735-1757``): lights past the first
    CLUSTER_LIGHTS are neither sampled nor exempt from the suppression of
    emission after a diffuse bounce, and the light table holds the
    emission in float32."""

    def __init__(self, arrays: dict, engine: str, device,
                 dtype=torch.float32):
        if engine not in ENGINES:
            raise ValueError(f"no reference for engine {engine!r}")

        def t(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        def shading_of(a):
            s = torch.cat([t(a["albedo"]).reshape(-1, 3),
                           t(a["metallic"])[:, None],
                           t(a["roughness"])[:, None],
                           t(a["emission"]).reshape(-1, 3),
                           t(a["ior"])[:, None]], dim=1)
            if engine == "cluster":
                s = s.to(torch.bfloat16).to(torch.float32)
            return s.to(dtype)

        self.engine, self.dtype = engine, dtype
        self.device = torch.device(device)
        radius = t(arrays["radius"])
        center = t(arrays["center"]).reshape(-1, 3)
        emission = t(arrays["emission"]).reshape(-1, 3)
        self.n_spheres = radius.shape[0]
        self.center = center.to(dtype)
        self.radius = radius.to(dtype)
        self.inv_r = torch.where(radius > 0.0, 1.0 / radius,
                                 torch.zeros_like(radius)).to(dtype)
        self.shading = shading_of(arrays)
        self.background = t(arrays["background"]).to(dtype)

        mesh = arrays.get("mesh")
        self.n_tris = 0 if mesh is None else int(
            np.asarray(mesh["vertices"]).shape[0])
        tri_shading = self.shading.new_zeros((0, 9))
        normal = torch.zeros((0, 3), device=device)
        if self.n_tris:
            v0, e1, e2, nrm = _face_frame(mesh["vertices"])
            self.v0, self.e1, self.e2 = (t(x).to(dtype)
                                         for x in (v0, e1, e2))
            tri_shading = shading_of(mesh)
            normal = t(nrm)
            if engine == "cluster":
                normal = normal.to(torch.bfloat16).to(torch.float32)
        # the winner planes (cx cy cz inv_r ar ag ab met rgh er eg eb ior)
        # of each sphere, each triangle (no centre, 1/r 0) and a miss
        miss = torch.zeros((1, 13), dtype=dtype, device=device)
        miss[0, 12] = 1.0
        self._planes = torch.cat([
            torch.cat([self.center, self.inv_r[:, None], self.shading], 1),
            torch.cat([tri_shading.new_zeros((self.n_tris, 4)),
                       tri_shading], 1),
            miss])
        self._normals = torch.cat([
            torch.zeros((self.n_spheres, 3), device=device), normal,
            torch.zeros((1, 3), device=device)]).to(dtype)

        is_light = (emission.amax(dim=1) > 0.0) & (radius > 0.0)
        if engine == "pallas":
            rows = torch.arange(self.n_spheres, device=device)
            lw = is_light.to(torch.float32)
            l_radius = radius
        else:
            rows = torch.argsort((~is_light).to(torch.int8), stable=True)[
                :CLUSTER_LIGHTS]
            lw = is_light[rows].to(torch.float32)
            l_radius = radius[rows] * lw
        n_lights = lw.sum()
        self.light_cdf = (torch.cumsum(lw, 0)
                          / torch.clamp_min(n_lights, 1.0)).to(dtype)
        self.n_lights = n_lights.to(dtype)
        # (cx, cy, cz, r, er, eg, eb) of each row of the light table
        self.lights = torch.cat([center[rows], l_radius[:, None],
                                 emission[rows]], dim=1).to(dtype)

    # -- the search ---------------------------------------------------------
    # Every (ray, primitive) pair that could register a hit is tested with
    # the kernels' arithmetic; a pair is left out only where a bound with a
    # wide margin shows that the ray passes far from the primitive. Past
    # DENSE_MAX primitives of a kind, the large ones (over 16 times the
    # median size) are tested with every ray, and the others are split at
    # medians into groups of at most GROUP: a ray tests a group only where
    # it passes within the group's bounding sphere, widened by the margin.

    def _sphere_groups(self):
        if getattr(self, "_sph_grouped", None) is None:
            c = self.center.double().cpu().numpy()
            r = self.radius.double().cpu().numpy()
            big = r > 16.0 * np.median(r)
            rest = np.flatnonzero(~big)

            def bounds(idx):
                lo = (c[idx] - r[idx, None]).min(0)
                hi = (c[idx] + r[idx, None]).max(0)
                mid = 0.5 * (lo + hi)
                return (mid, (np.linalg.norm(c[idx] - mid, axis=1)
                              + r[idx]).max(), max(r[idx].min(), 1e-6))

            self._sph_grouped = _grouped(
                _leaves(c, rest) if len(rest) else [], big, bounds,
                self.device)
        return self._sph_grouped

    def _tri_groups(self):
        """Groups of triangles: a group's bounding sphere is centred in
        the box of its triangles (v0, v0 + e1, v0 + e2) and holds their
        corners; no least radius widens its margin."""
        if getattr(self, "_tri_grouped", None) is None:
            v0 = self.v0.double().cpu().numpy()
            pts = np.stack([v0, v0 + self.e1.double().cpu().numpy(),
                            v0 + self.e2.double().cpu().numpy()], 1)
            lo, hi = pts.min(1), pts.max(1)
            size = np.linalg.norm(hi - lo, axis=1)
            big = size > 16.0 * np.median(size)
            rest = np.flatnonzero(~big)

            def bounds(idx):
                mid = 0.5 * (lo[idx].min(0) + hi[idx].max(0))
                return (mid, np.linalg.norm(pts[idx] - mid, axis=2).max(),
                        np.inf)

            self._tri_grouped = _grouped(
                _leaves(0.5 * (lo + hi), rest) if len(rest) else [], big,
                bounds, self.device)
        return self._tri_grouped

    def _roots(self, o, d, rays, sph):
        """(root, valid) of each ray against each of its spheres (P, M):
        the nearer root at or past T_MIN, else the farther; the square
        root of a negative discriminant is NaN and fails every compare."""
        s = sph.clamp_min(0)
        c = self.center[s]
        ocx = o[0][rays, None] - c[..., 0]
        ocy = o[1][rays, None] - c[..., 1]
        ocz = o[2][rays, None] - c[..., 2]
        half_b = (ocx * d[0][rays, None] + ocy * d[1][rays, None]
                  + ocz * d[2][rays, None])
        r = self.radius[s]
        cq = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
        sqrtd = sqrt(half_b * half_b - cq)
        root0 = -half_b - sqrtd
        root = torch.where(root0 >= T_MIN, root0, sqrtd - half_b)
        return root, (root >= T_MIN) & (self.inv_r[s] > 0.0) & (sph >= 0)

    def _tri_ts(self, o, d, rays, tri):
        """(t, valid) of each ray against each of its triangles (P, M):
        Moller-Trumbore in the order of operations of the program's plain
        version (``ops/megakernel.py:615 mt_test``, as
        ``ops/triangle.py:252`` documents it): p = d x e2, det = e1 . p,
        u = (o - v0) . p / det, q = (o - v0) x e1, v = d . q / det, t =
        e2 . q / det, each over the reciprocal of det. Two-sided: a back
        face hits as a front face does; |det| <= DET_EPS never hits; u, v
        >= 0, u + v <= 1 and t >= T_MIN."""
        s = tri.clamp_min(0)
        v0x, v0y, v0z = self.v0[s].unbind(-1)
        e1x, e1y, e1z = self.e1[s].unbind(-1)
        e2x, e2y, e2z = self.e2[s].unbind(-1)
        ox, oy, oz = (x[rays, None] for x in o)
        dx, dy, dz = (x[rays, None] for x in d)
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        okd = torch.abs(det) > DET_EPS
        inv = 1.0 / torch.where(okd, det, 1.0)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * inv
        tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
        ok = (okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (tt >= T_MIN) & (tri >= 0))
        return tt, ok

    def _hits(self, o, d):
        """(rays, index (P, M), t, valid) of every block of candidate
        pairs, spheres first."""
        for rays, sph in _blocks(o, d, self.n_spheres, self._sphere_groups):
            root, ok = self._roots(o, d, rays, sph)
            yield rays, sph, root, ok
        for rays, tri in _blocks(o, d, self.n_tris, self._tri_groups):
            tt, ok = self._tri_ts(o, d, rays, tri)
            yield rays, tri + self.n_spheres, tt, ok

    def nearest(self, o, d):
        """(best t, winner index or -1) of each ray (o, d: triples of
        (R,)): the least t under T_MAX, the first in the shared index
        among equal t (the least of (t, index) as one int64 key: a
        positive float's bits order as the float)."""
        n = o[0].shape[0]
        none = (int(_f32_bits(T_MAX)) << 32) | M32
        key = torch.full((n,), none, dtype=torch.int64, device=o[0].device)
        for rays, idx, t, ok in self._hits(o, d):
            k = torch.where(ok, (_f32_bits(t) << 32) | idx, none)
            key.scatter_reduce_(0, rays, k.amin(dim=1), "amin")
        best_t = (key >> 32).to(torch.int32).view(torch.float32).to(self.dtype)
        idx = key & M32
        return best_t, torch.where(idx == M32, -1, idx)

    def occluded(self, o, d, t_edge):
        """Whether a sphere or a triangle has a hit in [T_MIN, t_edge)
        along each ray."""
        occ = torch.zeros(t_edge.shape, dtype=torch.bool, device=t_edge.device)
        for rays, _, t, ok in self._hits(o, d):
            hit = (ok & (t < t_edge[rays, None])).any(dim=1)
            occ[rays[hit]] = True
        return occ

    def winner_planes(self, idx):
        """(cx, cy, cz, inv_r, ar, ag, ab, met, rgh, er, eg, eb, ior) of
        each winner; zeros and ior 1 where there is none (-1); a triangle
        has no centre and 1/r 0."""
        return self._planes[idx].unbind(1)

    def face_normal(self, idx):
        """(is_tri, nx, ny, nz): whether each winner is a triangle, and its
        face normal (as the engine's table holds it; 0 where it is not a
        triangle)."""
        nx, ny, nz = self._normals[idx].unbind(1)
        return idx >= self.n_spheres, nx, ny, nz

    def pick_light(self, u):
        """The light of each draw ``u``: the first row of the light table
        whose cdf reaches it, as (cx, cy, cz, r, er, eg, eb) planes; zeros
        where none."""
        idx = (self.light_cdf[None, :] < u[:, None]).sum(dim=1)
        table = torch.cat([self.lights, self.lights.new_zeros((1, 7))])
        return table[idx].unbind(1)


# ---------------------------------------------------------------------------
# one path per lane
# ---------------------------------------------------------------------------

class _Draws:
    """The uniforms of one lane's stream, call site by call site."""

    def __init__(self, mix, dtype):
        self.mix, self.salt, self.dtype = mix, 0, dtype

    def __call__(self):
        self.salt += 1
        return uniform(self.mix, self.salt).to(self.dtype)


def _direct_light(sc: Scene, diffuse, h, n, thr, albedo, col, U):
    """Next-event estimation from the ``diffuse`` lanes: a light picked
    from the cdf, a direction in the cone it subtends, its entry t and,
    where it lies in front of the surface, does not enclose the hit and
    nothing blocks it, its radiance times the estimator's weight."""
    hx, hy, hz = h
    nx, ny, nz = n
    l_cx, l_cy, l_cz, l_r, l_er, l_eg, l_eb = sc.pick_light(U())
    tlx, tly, tlz = l_cx - hx, l_cy - hy, l_cz - hz
    d2 = torch.clamp_min(tlx * tlx + tly * tly + tlz * tlz, 1e-12)
    sin2 = (l_r * l_r) / d2
    inside = sin2 >= 1.0
    cos_max = sqrt(torch.clamp(1.0 - sin2, 0.0, 1.0))
    xi1, xi2 = U(), U()
    cos_t = 1.0 - xi1 * (1.0 - cos_max)
    sin_t = sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi_l = TWO_PI * xi2
    inv_dl = rsqrt(d2)
    wx, wy, wz = tlx * inv_dl, tly * inv_dl, tlz * inv_dl
    big = torch.abs(wx) > 0.9
    ax = torch.where(big, 0.0, 1.0).to(wx.dtype)
    ay = torch.where(big, 1.0, 0.0).to(wx.dtype)
    t1x, t1y, t1z = normalize3(ay * wz, -ax * wz, ax * wy - ay * wx)
    t2x = wy * t1z - wz * t1y
    t2y = wz * t1x - wx * t1z
    t2z = wx * t1y - wy * t1x
    sc_ = sin_t * torch.cos(phi_l)
    ss = sin_t * torch.sin(phi_l)
    ldx = wx * cos_t + t1x * sc_ + t2x * ss
    ldy = wy * cos_t + t1y * sc_ + t2y * ss
    ldz = wz * cos_t + t1z * sc_ + t2z * ss
    weight = TWO_PI * (1.0 - cos_max)
    lox, loy, loz = hx - l_cx, hy - l_cy, hz - l_cz
    lhb = lox * ldx + loy * ldy + loz * ldz
    lcq = lox * lox + loy * loy + loz * loz - l_r * l_r
    ldisc = lhb * lhb - lcq
    lsq = sqrt(torch.clamp_min(ldisc, 0.0))
    lt0 = -lhb - lsq
    lt1 = -lhb + lsq
    t_light = torch.where(lt0 >= T_MIN, lt0, lt1)
    light_ok = (ldisc >= 0.0) & (t_light >= T_MIN)
    t_edge = t_light - T_MIN
    ndl = nx * ldx + ny * ldy + nz * ldz
    gate = diffuse & light_ok & ~inside & (ndl > 0.0) & (sc.n_lights > 0.0)
    idx = gate.nonzero()[:, 0]
    occ = sc.occluded((hx[idx], hy[idx], hz[idx]),
                      (ldx[idx], ldy[idx], ldz[idx]), t_edge[idx])
    gate = gate.index_put((idx,), ~occ)
    scale = gate.to(wx.dtype) * ndl * weight * (sc.n_lights * INV_PI)
    (tr, tg, tb), (ar, ag, ab), (cr, cg, cb) = thr, albedo, col
    return (cr + tr * ar * scale * l_er, cg + tg * ag * scale * l_eg,
            cb + tb * ab * scale * l_eb)


def trace_lanes(sc: Scene, cam: torch.Tensor, px, py, mix, *, width,
                height, max_depth, nee=False):
    """The radiance of one path per lane: pixel (px, py) (float planes),
    stream ``mix`` (int64, ``flat ^ seed * C``). Returns ((cr, cg, cb),
    segments traced per lane, path and shadow, as int64).

    A triangle that wins shades with its face normal turned against the
    ray; with NEE its emission is never suppressed after a diffuse bounce
    (``ops/megakernel.py:396``), and it is never sampled as a light."""
    dt = sc.dtype
    dev = mix.device
    n = mix.shape[0]
    U = _Draws(mix, dt)
    (cpx, cpy, cpz, fwx, fwy, fwz, rix, riy, riz, upx, upy, upz,
     tf_aspect, tf, _, _) = cam.unbind(0)
    xu, xv = U(), U()
    u = (px + xu) * f32(1.0 / width)
    v = (py + xv) * f32(1.0 / height)
    vx = (u - 0.5) * 2.0 * tf_aspect
    vy = (0.5 - v) * 2.0 * tf
    dx, dy, dz = normalize3(fwx + rix * vx + upx * vy,
                            fwy + riy * vx + upy * vy,
                            fwz + riz * vx + upz * vy)
    ox, oy, oz = cpx.expand(n), cpy.expand(n), cpz.expand(n)
    tr = torch.ones(n, dtype=dt, device=dev)
    tg, tb = tr, tr
    cr = torch.zeros(n, dtype=dt, device=dev)
    cg, cb = cr, cr
    act = torch.ones(n, dtype=torch.bool, device=dev)
    no_emit = torch.zeros_like(act)
    segs = torch.zeros(n, dtype=torch.int64, device=dev)
    bgx, bgy, bgz = sc.background.unbind(0)

    for depth_idx in range(1, max_depth + 1):
        segs += act
        best_t, best_i = sc.nearest((ox, oy, oz), (dx, dy, dz))
        (b_cx, b_cy, b_cz, b_ir, b_ar, b_ag, b_ab, b_met, b_rgh, b_er, b_eg,
         b_eb, _) = sc.winner_planes(best_i)
        face = sc.face_normal(best_i) if sc.n_tris else None

        hit = best_t < T_MAX
        missf = (act & ~hit).to(dt)
        cr = cr + missf * tr * bgx
        cg = cg + missf * tg * bgy
        cb = cb + missf * tb * bgz
        act = act & hit
        if nee:
            eocx, eocy, eocz = ox - b_cx, oy - b_cy, oz - b_cz
            eoc2 = eocx * eocx + eocy * eocy + eocz * eocz
            suppress = no_emit & ~(eoc2 * (b_ir * b_ir) < 1.0)
            if face is not None:
                suppress = suppress & ~face[0]
            emitf = (act & ~suppress).to(dt)
        else:
            emitf = act.to(dt)
        cr = cr + emitf * tr * b_er
        cg = cg + emitf * tg * b_eg
        cb = cb + emitf * tb * b_eb

        if depth_idx > RR_START:
            xi_rr = U()
            p = torch.clamp(torch.maximum(tr, torch.maximum(tg, tb)),
                            0.1, 0.95)
            act = act & (xi_rr < p)
            comp = torch.where(act, 1.0 / p, 1.0)
            tr, tg, tb = tr * comp, tg * comp, tb * comp

        hx, hy, hz = ox + dx * best_t, oy + dy * best_t, oz + dz * best_t
        nx = (hx - b_cx) * b_ir
        ny = (hy - b_cy) * b_ir
        nz = (hz - b_cz) * b_ir
        if face is not None:
            is_tri, tnx, tny, tnz = face
            sgn = torch.where(dx * tnx + dy * tny + dz * tnz < 0.0, 1.0,
                              -1.0).to(dt)
            if sc.engine == "cluster":
                # the cluster engine hands the normal n to the shading as
                # a sphere of centre hit - n and 1/r the sign
                # (ops/cluster.py:1059-1062), which forms (hit - c) * 1/r
                tnx, tny, tnz = (hx - (hx - tnx), hy - (hy - tny),
                                 hz - (hz - tnz))
            nx = torch.where(is_tri, tnx * sgn, nx)
            ny = torch.where(is_tri, tny * sgn, ny)
            nz = torch.where(is_tri, tnz * sgn, nz)

        # a uniform point in the unit ball: direction x cube-root radius
        u1, u2, u3 = U(), U(), U()
        z = 1.0 - 2.0 * u1
        r_xy = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = TWO_PI * u2
        r = torch.exp(torch.log(torch.clamp_min(u3, 1e-12)) * THIRD)
        bx = r_xy * torch.cos(phi) * r
        by = r_xy * torch.sin(phi) * r
        bz = z * r

        d_dot_n = dx * nx + dy * ny + dz * nz
        mx, my, mz = normalize3(dx - 2.0 * d_dot_n * nx + bx * b_rgh,
                                dy - 2.0 * d_dot_n * ny + by * b_rgh,
                                dz - 2.0 * d_dot_n * nz + bz * b_rgh)
        if nee:
            # the exact cosine sampler: normal + a unit-sphere direction
            sx, sy, sz = normalize3(bx, by, bz)
            cdx, cdy, cdz = nx + sx, ny + sy, nz + sz
            l2 = cdx * cdx + cdy * cdy + cdz * cdz
            deg = l2 < 1e-12
            inv = rsqrt(torch.clamp_min(l2, 1e-20))
            fx = torch.where(deg, nx, cdx * inv)
            fy = torch.where(deg, ny, cdy * inv)
            fz = torch.where(deg, nz, cdz * inv)
        else:
            sgn = torch.where(bx * nx + by * ny + bz * nz > 0.0, 1.0, -1.0)
            sgn = sgn.to(dt)
            fx, fy, fz = normalize3(nx + bx * sgn, ny + by * sgn,
                                    nz + bz * sgn)
        is_metal = b_met > 0.0
        ndx = torch.where(is_metal, mx, fx)
        ndy = torch.where(is_metal, my, fy)
        ndz = torch.where(is_metal, mz, fz)

        if nee:
            diffuse = act & ~is_metal
            cr, cg, cb = _direct_light(sc, diffuse, (hx, hy, hz),
                                       (nx, ny, nz), (tr, tg, tb),
                                       (b_ar, b_ag, b_ab), (cr, cg, cb), U)
            no_emit = diffuse
            segs += diffuse

        tr, tg, tb = tr * b_ar, tg * b_ag, tb * b_ab
        ox = torch.where(act, hx, ox)
        oy = torch.where(act, hy, oy)
        oz = torch.where(act, hz, oz)
        dx = torch.where(act, ndx, dx)
        dy = torch.where(act, ndy, dy)
        dz = torch.where(act, ndz, dz)
    return (cr, cg, cb), segs


# ---------------------------------------------------------------------------
# pixels, batches, the accumulation and the display
# ---------------------------------------------------------------------------

def tile_grid(engine: str, width: int, height: int):
    """(number of tiles, number of tiles that hold only real pixels)."""
    if engine == "pallas":
        n = width * height
        return -(-n // TILE), n // TILE
    bx, by = -(-width // LANES), -(-height // SUBLANES)
    return bx * by, bx * (height // SUBLANES)


def tile_pixels(engine: str, tiles, width: int, height: int, device):
    """(x, y) int64 of every pixel of the given whole tiles, tile by tile,
    and the tile of each."""
    tiles = torch.as_tensor(list(tiles), dtype=torch.int64, device=device)
    k = torch.arange(TILE, dtype=torch.int64, device=device)
    if engine == "pallas":
        flat = (tiles[:, None] * TILE + k).reshape(-1)
        x, y = flat % width, flat // width
    else:
        bx = -(-width // LANES)
        x = ((tiles[:, None] % bx) * LANES + k % LANES).reshape(-1)
        y = ((tiles[:, None] // bx) * SUBLANES + k // LANES).reshape(-1)
    return x, y, tiles.repeat_interleave(TILE)


def varying_tiles(sc: Scene, cam, engine: str, seed: int, *, width,
                  height, max_depth, nee=False, probes=4, samples=4,
                  share=0.25) -> list:
    """The whole tiles where the image varies most from sample to sample:
    ``samples`` paths of stream ``seed`` through each of ``probes`` x
    ``probes`` pixels spread over a tile, and the ``share`` of the tiles
    whose probes' variance is largest (of those where it is not 0; every
    whole tile where it is 0 everywhere). Background, or a surface that
    sees only the uniform background, renders the same value from every
    path and tests little of the accumulation."""
    _, n_whole = tile_grid(engine, width, height)
    dev = sc.device
    x, y, tile = tile_pixels(engine, range(n_whole), width, height, dev)
    step = TILE // (probes * probes)
    x, y, tile = x[::step], y[::step], tile[::step]
    col, _ = trace_pixels(sc, cam, engine, seed, x, y, tile, width=width,
                          height=height, spp=samples, max_depth=max_depth,
                          nee=nee)
    var = col.double().var(dim=1).sum(dim=-1)
    per_tile = torch.zeros(n_whole, dtype=torch.float64, device=dev)
    per_tile.index_add_(0, tile, var)
    order = torch.argsort(per_tile, descending=True, stable=True).tolist()
    varying = [t for t in order if per_tile[t] > 0.0]
    if not varying:
        return list(range(n_whole))
    return sorted(varying[:max(1, int(share * len(varying)))])


def stream_mix(engine: str, seed: int, x, y, tile, s, *, width, spp):
    """``flat ^ (stream seed) * C`` of sample(s) ``s`` of pixels (x, y)."""
    flat = (y * width + x) & M32
    if engine == "pallas":
        lane_seed = (((tile + (int(seed) & M32)) & M32) + s * 7919) & M32
    else:
        lane_seed = (tile * spp + (s + int(seed))) & M32
    return flat ^ mul32(lane_seed, C_SEED)


def trace_pixels(sc: Scene, cam, engine: str, seed: int, x, y, tile, *,
                 width, height, spp, max_depth, nee=False):
    """``spp`` samples of stream ``seed`` through pixels (x, y) of the
    given tiles: ((P, spp, 3) radiance, segments traced)."""
    P = x.shape[0]
    s = torch.arange(spp, dtype=torch.int64, device=x.device)
    mix = stream_mix(engine, seed, x[:, None], y[:, None], tile[:, None],
                     s[None, :], width=width, spp=spp).reshape(-1)
    rep = (lambda a: a[:, None].expand(P, spp).reshape(-1).to(sc.dtype))
    col, segs = trace_lanes(sc, cam, rep(x), rep(y), mix, width=width,
                            height=height, max_depth=max_depth, nee=nee)
    return torch.stack(col, dim=-1).reshape(P, spp, 3), int(segs.sum())


def render_tiles(sc: Scene, cam, engine: str, seed: int, tiles, *, width,
                 height, spp, max_depth, nee=False):
    """One batch's pixels of the given whole tiles: ((P, 3) mean with sqrt
    gamma and clamp, (P,) x, (P,) y, segments traced over those tiles)."""
    dev = sc.device
    x, y, tile = tile_pixels(engine, tiles, width, height, dev)
    P = x.shape[0]
    col, segs = trace_pixels(sc, cam, engine, seed, x, y, tile, width=width,
                             height=height, spp=spp, max_depth=max_depth,
                             nee=nee)
    acc = torch.zeros((P, 3), dtype=sc.dtype, device=dev)
    for k in range(spp):  # in sample order
        acc = acc + col[:, k]
    mean = torch.clamp(sqrt(torch.clamp_min(acc * f32(1.0 / spp), 0.0)),
                       0.0, 1.0)
    return mean, x, y, segs


def accumulate(acc, total: int, batch, n: int):
    """The progressive mean: old * total/(total+n) + new * n/(total+n)."""
    if acc is None or total == 0:
        return batch, n
    new_total = total + n
    return acc * (total / new_total) + batch * (n / new_total), new_total


def tone_map(img, exposure: float):
    img = img * exposure
    img = img / (1.0 + img)
    return torch.clamp(img, 0.0, 1.0)


def _percentiles(values, qs):
    """Linearly interpolated quantiles: the position q (n - 1) in float32,
    the sorted values at its floor and ceiling, weighted by its
    fraction."""
    ordered = torch.sort(values).values
    n = values.numel()
    out = []
    for q in qs:
        pos = np.float32(q) * np.float32(n - 1)
        low, high = np.floor(pos), np.ceil(pos)
        w_high = pos - low
        w_low = np.float32(1.0) - w_high
        out.append(ordered[min(int(low), n - 1)] * float(w_low)
                   + ordered[min(int(high), n - 1)] * float(w_high))
    return out


def display_stack(acc, exposure: float):
    """(2, H, W, 3) uint8: the tone-mapped view and its 2-98 percentile
    stretch, rounded half to even."""
    disp = tone_map(acc, exposure)
    lo, hi = _percentiles(disp.reshape(-1), (0.02, 0.98))
    stretched = torch.clamp((disp - lo) / torch.clamp_min(hi - lo, 1e-12),
                            0.0, 1.0)
    enhanced = torch.where(hi > lo, stretched, disp)
    stack = torch.stack([disp, enhanced])
    return torch.round(torch.clamp(stack, 0.0, 1.0) * 255.0).to(torch.uint8)


def render_unit(sc: Scene, cam, engine: str, seeds, tiles, *, width,
                height, spp, max_depth, nee=False):
    """A unit of progressive batches (one stream seed each) over whole
    tiles, accumulated in order: ((P, 3) accumulator, x, y, segments of
    the first batch)."""
    acc, total, first_segs = None, 0, None
    for seed in seeds:
        mean, x, y, segs = render_tiles(sc, cam, engine, seed, tiles,
                                        width=width, height=height, spp=spp,
                                        max_depth=max_depth, nee=nee)
        if first_segs is None:
            first_segs = segs
        acc, total = accumulate(acc, total, mean, spp)
    return acc, x, y, first_segs
