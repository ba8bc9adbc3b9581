"""The benchmark's own scene recipes: a configuration's scene as host
arrays, which the harness hands to the program (as ``api`` Scene/Sphere
objects and a ``TriangleMesh``) and to the reference alike. Frozen here so
that a change to the program's scene library cannot change what is
measured; no recipe imports anything of the program.

A scene is spheres (``FIELDS``, one row per sphere), a background and an
optional triangle mesh (``MESH_FIELDS``, one row per triangle; None for a
scene of spheres alone). Kinds (``RECIPES``):

* ``spheres``: sphere rows inline (``columns``, ``rows``);
* ``random_spheres``: *Ray Tracing in One Weekend*'s random field;
* ``terrain``: a sinusoidal heightfield of 2 (n - 1)^2 triangles under
  three spheres, one of them emissive;
* ``triangles``: inline faces (triangles or quads) beside inline sphere
  rows, as the Cornell box is built.
"""

from __future__ import annotations

import numpy as np

FIELDS = ("center", "radius", "albedo", "metallic", "roughness", "emission",
          "ior")
MESH_FIELDS = ("vertices", "albedo", "metallic", "roughness", "emission",
               "ior", "object_id")
# a face's material where the recipe does not state it (the program's
# make_mesh defaults)
FACE_DEFAULTS = {"albedo": (0.8, 0.8, 0.8), "metallic": 0.0,
                 "roughness": 0.5, "emission": (0.0, 0.0, 0.0), "ior": 1.5,
                 "object_id": 0}


def _sphere_rows(table: dict) -> dict:
    """Sphere fields from ``{"columns": [...], "rows": [[...], ...]}``."""
    cols = table["columns"]
    rows = np.asarray(table["rows"], np.float32).reshape(-1, len(cols))

    def col(*names):
        return rows[:, [cols.index(n) for n in names]]

    return {
        "center": col("cx", "cy", "cz"),
        "radius": col("radius")[:, 0],
        "albedo": col("ar", "ag", "ab"),
        "metallic": col("metallic")[:, 0],
        "roughness": col("roughness")[:, 0],
        "emission": col("er", "eg", "eb"),
        "ior": col("ior")[:, 0],
    }


def _from_rows(scene: dict) -> dict:
    return dict(_sphere_rows(scene), mesh=None)


def random_spheres(n: int, seed: int, spread: float,
                   emissive_fraction: float) -> dict:
    """A field of n - 1 random spheres over a ground sphere of radius 1000,
    drawn from numpy's default generator in a fixed order."""
    rng = np.random.default_rng(seed)
    m = n - 1
    centers = np.zeros((n, 3), np.float32)
    radii = np.zeros((n,), np.float32)
    albedos = np.zeros((n, 3), np.float32)
    metallics = np.zeros((n,), np.float32)
    roughnesses = np.full((n,), 0.5, np.float32)
    emissions = np.zeros((n, 3), np.float32)
    centers[0] = (0, -1000.0, 0)
    radii[0] = 1000.0
    albedos[0] = (0.5, 0.5, 0.5)
    r = rng.uniform(0.2, 0.6, m).astype(np.float32)
    centers[1:, 0] = rng.uniform(-spread, spread, m)
    centers[1:, 2] = rng.uniform(-spread - 4.0, -1.0, m)
    centers[1:, 1] = r
    radii[1:] = r
    albedos[1:] = rng.uniform(0.1, 0.95, (m, 3))
    kind = rng.uniform(size=m)
    metallics[1:] = np.where(kind < 0.3, rng.uniform(0.6, 1.0, m), 0.0)
    roughnesses[1:] = rng.uniform(0.0, 0.8, m)
    emissive = kind > 1.0 - emissive_fraction
    emissions[1:][emissive] = rng.uniform(2.0, 8.0, (int(emissive.sum()), 3))
    return {"center": centers, "radius": radii, "albedo": albedos,
            "metallic": metallics, "roughness": roughnesses,
            "emission": emissions, "ior": np.full((n,), 1.5, np.float32),
            "mesh": None}


def _faces(vertices: np.ndarray, **material) -> dict:
    """Mesh fields of (F, 3, 3) float32 vertices, each material a value
    for every face or one row per face (``FACE_DEFAULTS`` where absent)."""
    f = vertices.shape[0]
    mat = dict(FACE_DEFAULTS, **material)

    def per_face(name, width, dtype=np.float32):
        shape = (f,) if width == 1 else (f, width)
        return np.ascontiguousarray(np.broadcast_to(
            np.asarray(mat[name], dtype), shape))

    return {"vertices": np.ascontiguousarray(vertices, np.float32),
            "albedo": per_face("albedo", 3),
            "metallic": per_face("metallic", 1),
            "roughness": per_face("roughness", 1),
            "emission": per_face("emission", 3),
            "ior": per_face("ior", 1),
            "object_id": per_face("object_id", 1, np.int32)}


def terrain(n: int, extent: float, seed: int) -> dict:
    """A sinusoidal heightfield of 2 (n - 1)^2 triangles over [-extent,
    extent] x [-2, -2 - 2 extent], each face's albedo drawn from numpy's
    default generator of ``seed``, roughness 0.6, under a red diffuse
    sphere, a mirror sphere and an emissive sphere (n = 72: 10,082
    triangles)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent, extent, n, dtype=np.float32)
    zs = np.linspace(-2.0, -2.0 - 2 * extent, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = (0.8 * np.sin(gx * 0.7) * np.cos(gz * 0.5)
          + 0.3 * np.sin(gx * 1.9 + 1.0) * np.sin(gz * 1.3)
          ).astype(np.float32)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0)
    albedo = rng.uniform(0.3, 0.9, (faces.shape[0], 3)).astype(np.float32)
    return {
        "center": np.array([(-3.0, 2.0, -8.0), (3.0, 2.5, -12.0),
                            (0.0, 9.0, -12.0)], np.float32),
        "radius": np.array([1.2, 1.5, 2.0], np.float32),
        "albedo": np.array([(0.9, 0.3, 0.3), (0.85, 0.85, 0.9),
                            (0.0, 0.0, 0.0)], np.float32),
        "metallic": np.array([0.0, 1.0, 0.0], np.float32),
        "roughness": np.array([0.4, 0.05, 0.0], np.float32),
        "emission": np.array([(0, 0, 0), (0, 0, 0), (10.0, 10.0, 9.0)],
                             np.float32),
        "ior": np.full((3,), 1.5, np.float32),
        "background": np.array([0.2, 0.3, 0.5], np.float32),
        "mesh": _faces(verts[faces], albedo=albedo, roughness=0.6),
    }


def triangles(scene: dict) -> dict:
    """Inline faces beside inline sphere rows: ``spheres`` as the
    ``spheres`` kind holds them and ``faces``, a list of ``{"triangle":
    [v0, v1, v2]}`` or ``{"quad": [p0, p1, p2, p3]}`` (two triangles, (p0,
    p1, p2) and (p0, p2, p3)), each with optional ``albedo``,
    ``metallic``, ``roughness``, ``emission``, ``ior`` and ``object_id``
    (``FACE_DEFAULTS``), in order."""
    out = _sphere_rows(scene["spheres"])
    parts = []
    for face in scene["faces"]:
        if "quad" in face:
            p = np.asarray(face["quad"], np.float32).reshape(4, 3)
            verts = np.stack([p[[0, 1, 2]], p[[0, 2, 3]]])
        else:
            verts = np.asarray(face["triangle"], np.float32).reshape(1, 3, 3)
        parts.append(_faces(verts, **{k: face[k] for k in FACE_DEFAULTS
                                      if k in face}))
    out["mesh"] = {k: np.concatenate([p[k] for p in parts])
                   for k in MESH_FIELDS}
    return out


RECIPES = {
    "spheres": _from_rows,
    "random_spheres": lambda s: random_spheres(
        s["n"], s["seed"], s["spread"], s["emissive_fraction"]),
    "terrain": lambda s: terrain(s["n"], s["extent"], s["seed"]),
    "triangles": triangles,
}


def scene_arrays(config: dict) -> dict:
    """The configuration's scene: float32 arrays of FIELDS, one row per
    sphere, the background (3,) (the configuration's, unless the recipe
    fixes it) and ``mesh``: None, or MESH_FIELDS with one row per triangle
    (vertices (F, 3, 3), object_id int32)."""
    scene = config["scene"]
    if scene["kind"] not in RECIPES:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    out = RECIPES[scene["kind"]](scene)
    if "background" not in out:
        out["background"] = np.asarray(scene["background"], np.float32)
    return out
