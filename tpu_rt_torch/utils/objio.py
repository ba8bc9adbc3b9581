"""Wavefront OBJ import and export for TriangleMesh.

Counterpart of ``tpu_rt/utils/objio.py``, copied (that module is free of
jax, but importing it would import the JAX package) and building meshes
with the port's ``make_mesh`` on a requested device. Pure numpy text
parsing.

Supported subset:
  * ``v x y z`` vertices; ``f`` faces with any of the index forms
    ``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``, 1-based or negative
    (relative) indices; polygons are fan-triangulated.
  * ``o``/``g`` starts a new object (distinct object_id per object).
  * ``mtllib``/``usemtl`` with these MTL fields: ``Kd`` (albedo),
    ``Ke`` (emission), ``Ni`` (ior), ``Ns`` (shininess -> roughness =
    clamp(1 - Ns/1000)), ``Pm``/``metallic`` (PBR extension), ``Pr``
    (PBR roughness, wins over Ns).
Normals and texture coordinates are parsed but unused: the engines shade
with geometric face normals.
"""

from __future__ import annotations

import os

import numpy as np


def _parse_mtl(path: str) -> dict[str, dict]:
    """Parse the material fields that map onto the port's materials."""
    mats: dict[str, dict] = {}
    cur: dict | None = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = mats.setdefault(" ".join(parts[1:]), {})
            elif cur is None:
                continue
            elif key == "Kd":
                cur["albedo"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ke":
                e = tuple(float(x) for x in parts[1:4])
                if any(v > 0 for v in e):
                    cur["emission"] = e
            elif key == "Ni":
                cur["ior"] = float(parts[1])
            elif key == "Ns" and "roughness" not in cur:
                cur["roughness"] = float(np.clip(1.0 - float(parts[1]) / 1000.0,
                                                 0.0, 1.0))
            elif key == "Pr":
                cur["roughness"] = float(np.clip(float(parts[1]), 0.0, 1.0))
            elif key in ("Pm", "metallic"):
                cur["metallic"] = float(np.clip(float(parts[1]), 0.0, 1.0))
    return mats


def _face_vertex(tok: str, n_verts: int) -> int:
    """Resolve one face-corner token to a 0-based vertex index."""
    v = tok.split("/")[0]
    i = int(v)
    return i - 1 if i > 0 else n_verts + i


def load_obj(
    path: str,
    default_albedo=(0.8, 0.8, 0.8),
    scale: float = 1.0,
    translate=(0.0, 0.0, 0.0),
    capacity: int | None = None,
    first_object_id: int = 0,
    *,
    device,
):
    """Load an OBJ file into a padded TriangleMesh on ``device``.

    ``scale``/``translate`` apply scale-then-translate in load order (OBJ
    files come in arbitrary units). Each ``o``/``g`` group gets its own
    object_id starting at ``first_object_id``; materials come from the
    referenced .mtl when present, else ``default_albedo``.
    """
    from ..ops.triangle import make_mesh

    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    face_mid: list[int] = []       # per-face index into mat_table
    face_oid: list[int] = []
    mats: dict[str, dict] = {}
    mat_table: list[dict] = [{"albedo": tuple(default_albedo)}]
    cur_mid = 0
    oid = first_object_id
    seen_face_in_group = False

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif key == "f":
                idx = [_face_vertex(tok, len(verts)) for tok in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    face_mid.append(cur_mid)
                    face_oid.append(oid)
                seen_face_in_group = True
            elif key in ("o", "g"):
                if seen_face_in_group:
                    oid += 1
                    seen_face_in_group = False
            elif key == "mtllib":
                mtl_path = os.path.join(os.path.dirname(path),
                                        " ".join(parts[1:]))
                mats.update(_parse_mtl(mtl_path))
            elif key == "usemtl":
                name = " ".join(parts[1:])
                m = dict(mats.get(name, {"albedo": default_albedo}))
                m.setdefault("albedo", tuple(default_albedo))
                mat_table.append(m)
                cur_mid = len(mat_table) - 1

    if not faces:
        raise ValueError(f"{path}: no faces found")

    v = (np.asarray(verts, np.float32) * np.float32(scale)
         + np.asarray(translate, np.float32))
    fc = np.asarray(faces, np.int64)
    mid = np.asarray(face_mid, np.int64)

    def field(name, default, width=None):
        # one row per material, fanned out to faces by index
        shape = (len(mat_table), width) if width else (len(mat_table),)
        table = np.empty(shape, np.float32)
        for j, m in enumerate(mat_table):
            table[j] = m.get(name, default)
        return table[mid]

    return make_mesh(
        v, fc,
        albedo=field("albedo", default_albedo, 3),
        metallic=field("metallic", 0.0),
        roughness=field("roughness", 0.5),
        emission=field("emission", (0.0, 0.0, 0.0), 3),
        ior=field("ior", 1.5),
        object_id=np.asarray(face_oid, np.int32),
        capacity=capacity,
        device=device,
    )


def save_obj(path: str, mesh, only_valid: bool = True) -> None:
    """Write a TriangleMesh back out as a triangle-soup OBJ (v0, v0+e1,
    v0+e2 per face; vertices are not deduplicated)."""
    v0 = mesh.v0.cpu().numpy()
    e1 = mesh.e1.cpu().numpy()
    e2 = mesh.e2.cpu().numpy()
    valid = mesh.valid.cpu().numpy()
    rows = np.flatnonzero(valid) if only_valid else np.arange(v0.shape[0])
    with open(path, "w") as f:
        f.write("# tpu-rt triangle soup\n")
        for i in rows:
            for p in (v0[i], v0[i] + e1[i], v0[i] + e2[i]):
                f.write(f"v {p[0]:.7g} {p[1]:.7g} {p[2]:.7g}\n")
        for k in range(len(rows)):
            b = 3 * k
            f.write(f"f {b + 1} {b + 2} {b + 3}\n")
