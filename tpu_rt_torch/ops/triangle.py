"""Triangle meshes: the struct-of-arrays type and its factories.

Counterpart of ``tpu_rt/ops/triangle.py`` for what the Pallas engines read:
``TriangleMesh``, the bucket sizes, ``make_mesh``, ``merge_meshes``,
``tri_attribute_matrix``, ``quad`` and ``box``, the dense closest-hit
sweep the first-hit AOVs and the lax integrator use (``triangle_ts``,
``intersect_mesh_brute``), and the LBVH intersectors of the lax
integrator's ``use_bvh`` path (``mesh_lbvh``, ``triangle_leaf_fn``,
``intersect_mesh_bvh``, ``intersect_mesh_bvh_hit``). The geometry is built
in numpy exactly as the JAX package builds it (``np.cross``,
``np.linalg.norm``, the same padding fills), then moved to the requested
device, so both packages hold bit-equal fields.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.types import T_MAX, T_MIN, host_tensor
from .intersect import Hit, _fetch, _first_hit_onehot, outer_dot

# Minimum padded triangle bucket.
MIN_TRI_BUCKET = 128
# |det| below which a ray counts as parallel to a triangle
DET_EPS = 1e-9


class TriangleMesh(NamedTuple):
    """SoA triangle soup, padded to a static bucket; per-triangle material
    (the same fields as spheres)."""

    v0: torch.Tensor         # (T, 3) f32
    e1: torch.Tensor         # (T, 3) f32, v1 - v0
    e2: torch.Tensor         # (T, 3) f32, v2 - v0
    normal: torch.Tensor     # (T, 3) f32, normalize(e1 x e2)
    albedo: torch.Tensor     # (T, 3) f32
    metallic: torch.Tensor   # (T,)   f32
    roughness: torch.Tensor  # (T,)   f32
    emission: torch.Tensor   # (T, 3) f32
    ior: torch.Tensor        # (T,)   f32
    object_id: torch.Tensor  # (T,)   i32
    valid: torch.Tensor      # (T,)   bool

    @property
    def capacity(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device


_DTYPES = {"object_id": torch.int32, "valid": torch.bool}


def _to_mesh(fields: dict, device) -> TriangleMesh:
    return TriangleMesh(**{
        k: host_tensor(fields[k], _DTYPES.get(k, torch.float32), device)
        for k in TriangleMesh._fields})


def tri_bucket(n: int) -> int:
    """Static padded capacity for ``n`` triangles."""
    cap = MIN_TRI_BUCKET
    while cap < n:
        cap *= 2
    return cap


def make_mesh(
    vertices,
    faces,
    albedo=(0.8, 0.8, 0.8),
    metallic=0.0,
    roughness=0.5,
    emission=(0.0, 0.0, 0.0),
    ior=1.5,
    object_id=0,
    capacity: int | None = None,
    *,
    device,
) -> TriangleMesh:
    """A padded TriangleMesh on ``device`` from (V, 3) vertices and (F, 3)
    int faces. Scalar materials broadcast to all faces; per-face arrays are
    also accepted. Padding rows are zero, with ior 1.5, object id -1 and
    ``valid=False``."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    n = faces.shape[0]
    cap = capacity if capacity is not None else tri_bucket(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < face count {n}")

    tri = vertices[faces]            # (F, 3, 3)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    nrm = np.cross(e1, e2)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-20), [0.0, 0.0, 1.0])

    def pad3(x, fill=0.0):
        x = np.broadcast_to(np.asarray(x, np.float32), (n, 3))
        out = np.full((cap, 3), fill, np.float32)
        out[:n] = x
        return out

    def pad1(x, fill=0.0, dtype=np.float32):
        x = np.broadcast_to(np.asarray(x, dtype), (n,))
        out = np.full((cap,), fill, dtype)
        out[:n] = x
        return out

    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return _to_mesh(dict(
        v0=pad3(v0), e1=pad3(e1), e2=pad3(e2), normal=pad3(nrm),
        albedo=pad3(albedo), metallic=pad1(metallic),
        roughness=pad1(roughness), emission=pad3(emission),
        ior=pad1(ior, fill=1.5),
        object_id=pad1(object_id, fill=-1, dtype=np.int32),
        valid=valid), device)


def merge_meshes(meshes: list[TriangleMesh],
                 capacity: int | None = None) -> TriangleMesh:
    """Concatenate meshes into one padded soup on the first mesh's device
    (for multi-object scenes)."""
    counts = [int(m.valid.sum()) for m in meshes]
    total = sum(counts)
    cap = capacity if capacity is not None else tri_bucket(total)
    fields = {}
    for name in TriangleMesh._fields:
        cat = np.concatenate([getattr(m, name).cpu().numpy()[:c]
                              for m, c in zip(meshes, counts)], axis=0)
        fill = False if name == "valid" else (-1 if name == "object_id" else 0)
        out = np.full((cap,) + cat.shape[1:], fill, cat.dtype)
        out[:total] = cat
        fields[name] = out
    return _to_mesh(fields, meshes[0].device)


def tri_attribute_matrix(mesh: TriangleMesh) -> torch.Tensor:
    """Packed (T, 16) attribute matrix.

    Columns: normal xyz, albedo rgb, metallic, roughness, emission rgb, ior,
    object_id, pad x3.
    """
    zeros = torch.zeros_like(mesh.ior)[:, None]
    return torch.cat(
        [
            mesh.normal,                                    # 0:3
            mesh.albedo,                                    # 3:6
            mesh.metallic[:, None],                         # 6
            mesh.roughness[:, None],                        # 7
            mesh.emission,                                  # 8:11
            mesh.ior[:, None],                              # 11
            mesh.object_id.to(torch.float32)[:, None],      # 12
            zeros, zeros, zeros,                            # 13:16 pad
        ],
        dim=-1,
    )


def triangle_ts(
    mesh: TriangleMesh,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> torch.Tensor:
    """Hit parameter per (ray, triangle), T_MAX where none, by the JAX
    package's decomposition of Moller-Trumbore into (R, 3) x (3, T)
    products (written out as in ``ops/intersect.py:outer_dot``).
    origins/directions: (R, 3) -> (R, T)."""
    n = vm.cross(mesh.e1, mesh.e2)             # (T, 3) unnormalized
    e2xv0 = vm.cross(mesh.e2, mesh.v0)
    e1xv0 = vm.cross(mesh.e1, mesh.v0)
    v0n = vm.dot(mesh.v0, n)                   # (T,)
    oxd = vm.cross(origins, directions)        # (R, 3)

    det = -outer_dot(directions, n)            # (R, T)
    t_num = outer_dot(origins, n) - v0n[None, :]
    u_num = outer_dot(oxd, mesh.e2) - outer_dot(directions, e2xv0)
    v_num = -outer_dot(oxd, mesh.e1) + outer_dot(directions, e1xv0)

    ok_det = torch.abs(det) > DET_EPS
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det,
                                                torch.ones_like(det)),
                      torch.zeros_like(det))
    t = t_num * inv
    u = u_num * inv
    v = v_num * inv
    ok = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t <= t_max) & mesh.valid[None, :])
    return torch.where(ok, t, torch.full_like(t, T_MAX))


def intersect_mesh_brute(
    mesh: TriangleMesh,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_min: float = T_MIN,
    t_max: float = T_MAX,
    attr: torch.Tensor | None = None,
):
    """Closest triangle hit as ``ops/intersect.py:Hit``; the normal is the
    face normal flipped to oppose the ray."""
    if attr is None:
        attr = tri_attribute_matrix(mesh)
    ts = triangle_ts(mesh, origins, directions, t_min, t_max)
    t = ts.amin(dim=-1)
    hit = t < T_MAX
    fetched = _fetch(_first_hit_onehot(ts, t), attr)

    n = fetched[:, 0:3]
    facing = (vm.dot(n, directions) < 0.0)[:, None]
    n = torch.where(facing, n, -n)
    return Hit(
        hit=hit,
        t=torch.where(hit, t, torch.full_like(t, T_MAX)),
        normal=n,
        albedo=fetched[:, 3:6],
        metallic=fetched[:, 6],
        roughness=fetched[:, 7],
        emission=fetched[:, 8:11],
        ior=fetched[:, 11],
        object_id=torch.where(hit, fetched[:, 12], torch.full_like(t, -1.0)),
    )


def mesh_lbvh(mesh: TriangleMesh):
    """LBVH over triangles (centroid Morton order, triangle boxes)."""
    from .bvh import build_lbvh

    p1 = mesh.v0 + mesh.e1
    p2 = mesh.v0 + mesh.e2
    tri_min = torch.minimum(mesh.v0, torch.minimum(p1, p2))
    tri_max = torch.maximum(mesh.v0, torch.maximum(p1, p2))
    centroid = (tri_min + tri_max) * 0.5
    return build_lbvh(centroid, tri_min, tri_max, mesh.valid)


def triangle_leaf_fn(mesh: TriangleMesh, prim_index, t_min: float = T_MIN):
    """Scalar Moller-Trumbore test of one sorted leaf per ray, for
    ``ops/bvh.py:traverse``."""

    def leaf_t(slot, o, d, cur_t):
        idx = prim_index[slot].long()
        i = torch.clamp_min(idx, 0)
        v0, e1, e2 = mesh.v0[i], mesh.e1[i], mesh.e2[i]
        pvec = vm.cross(d, e2)
        det = vm.dot(e1, pvec)
        ok = (torch.abs(det) > DET_EPS) & (idx >= 0)
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tvec = o - v0
        u = vm.dot(tvec, pvec) * inv
        qvec = vm.cross(tvec, e1)
        v = vm.dot(d, qvec) * inv
        t = vm.dot(e2, qvec) * inv
        ok = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t >= t_min) & (t <= cur_t))
        return torch.where(ok, t, torch.full_like(t, T_MAX))

    return leaf_t


def intersect_mesh_bvh(mesh: TriangleMesh, bvh, origins, directions):
    """BVH closest triangle: (t, original triangle index) per ray, -1 and
    T_MAX on a miss."""
    from .bvh import _prim_of, traverse

    t, slot = traverse(bvh, origins, directions,
                       triangle_leaf_fn(mesh, bvh.prim_index), T_MIN, T_MAX)
    return _prim_of(bvh, t, slot)


def intersect_mesh_bvh_hit(mesh: TriangleMesh, bvh, origins, directions):
    """BVH closest triangle hit as the ``Hit`` record that
    :func:`intersect_mesh_brute` returns (the face normal flipped to oppose
    the ray), attributes gathered by the winner's index: the lax engine's
    mesh intersector under ``use_bvh``."""
    t, prim = intersect_mesh_bvh(mesh, bvh, origins, directions)
    hit = prim >= 0
    idx = torch.clamp_min(prim, 0)
    n = mesh.normal[idx]
    facing = (vm.dot(n, directions) < 0.0)[:, None]
    n = torch.where(facing, n, -n)
    return Hit(
        hit=hit,
        t=t,
        normal=n,
        albedo=mesh.albedo[idx],
        metallic=mesh.metallic[idx],
        roughness=mesh.roughness[idx],
        emission=mesh.emission[idx],
        ior=mesh.ior[idx],
        object_id=torch.where(hit, mesh.object_id[idx].to(torch.float32),
                              torch.full_like(t, -1.0)),
    )


# ---------------------------------------------------------------------------
# mesh factories (test/demo geometry)
# ---------------------------------------------------------------------------

def quad(p0, p1, p2, p3, *, device, **mat) -> TriangleMesh:
    """Two-triangle quad with corners in winding order."""
    verts = np.asarray([p0, p1, p2, p3], np.float32)
    return make_mesh(verts, [[0, 1, 2], [0, 2, 3]], device=device, **mat)


def box(center=(0, 0, 0), size=(1, 1, 1), *, device, **mat) -> TriangleMesh:
    """Axis-aligned box, 12 triangles, outward winding."""
    c = np.asarray(center, np.float32)
    h = np.asarray(size, np.float32) / 2
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32)
    verts = c + corners * h
    # faces as corner indices (bit pattern: x*4 + y*2 + z), outward normals
    f = [
        (0, 1, 3, 2), (4, 6, 7, 5),  # -x, +x
        (0, 4, 5, 1), (2, 3, 7, 6),  # -y, +y
        (0, 2, 6, 4), (1, 5, 7, 3),  # -z, +z
    ]
    faces = []
    for a, b, cc, d in f:
        faces += [[a, b, cc], [a, cc, d]]
    return make_mesh(verts, faces, device=device, **mat)
