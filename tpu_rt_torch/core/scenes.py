"""Scene library: procedural test scenes.

Counterpart of ``tpu_rt/core/scenes.py``: ``random_spheres``, the classic
many-spheres field that drives the cluster engine past the megakernel's
64-sphere bucket, and the mesh scenes ``terrain_mesh`` (a heightfield of
2 (n-1)^2 triangles, the cluster engine's mesh workload) and
``cornell_box`` (12 triangles and 2 spheres, the megakernel's). The numpy
draws are the JAX package's, in the same order, so both packages build the
very same scene from one seed.
"""

from __future__ import annotations

import numpy as np

from .types import SphereScene, make_scene


def random_spheres(
    n: int = 64,
    seed: int = 0,
    spread: float = 10.0,
    emissive_fraction: float = 0.1,
    capacity: int | None = None,
    *,
    device,
) -> SphereScene:
    """A field of n random spheres over a ground sphere (the classic
    many-spheres benchmark scene), on ``device``. Deterministic in
    ``seed``."""
    rng = np.random.default_rng(seed)
    m = n - 1  # ground takes one slot
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

    return make_scene(
        centers=centers, radii=radii, albedos=albedos, metallics=metallics,
        roughnesses=roughnesses, emissions=emissions,
        background=(0.3, 0.4, 0.6), capacity=capacity, device=device,
    )


def terrain_mesh(n: int = 24, extent: float = 12.0, seed: int = 0, *,
                 device):
    """Procedural sinusoidal-heightfield terrain: 2*(n-1)^2 triangles.

    n=24 gives 1058 triangles, n=72 10,082, n=226 101,250. Returns
    (sphere_scene, mesh) on ``device``: a couple of spheres above a rolling
    lit terrain.
    """
    from ..ops.triangle import make_mesh

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

    f = faces.shape[0]
    albedo = rng.uniform(0.3, 0.9, (f, 3)).astype(np.float32)
    mesh = make_mesh(verts, faces, albedo=albedo, roughness=0.6,
                     device=device)

    spheres = make_scene(
        centers=[(-3.0, 2.0, -8.0), (3.0, 2.5, -12.0), (0.0, 9.0, -12.0)],
        radii=[1.2, 1.5, 2.0],
        albedos=[(0.9, 0.3, 0.3), (0.85, 0.85, 0.9), (0.0, 0.0, 0.0)],
        metallics=[0.0, 1.0, 0.0],
        roughnesses=[0.4, 0.05, 0.0],
        emissions=[(0, 0, 0), (0, 0, 0), (10.0, 10.0, 9.0)],
        background=(0.2, 0.3, 0.5),
        device=device,
    )
    return spheres, mesh


def cornell_box(*, device):
    """Cornell-style box as a TriangleMesh + a mirror/diffuse sphere pair,
    on ``device``.

    Returns (sphere_scene, mesh): render with
    ``render(sphere_scene, cam, ..., mesh=mesh)``.
    """
    from ..ops.triangle import merge_meshes, quad

    s = 2.0  # half-size
    white = dict(albedo=(0.73, 0.73, 0.73))
    red = dict(albedo=(0.65, 0.05, 0.05))
    green = dict(albedo=(0.12, 0.45, 0.15))
    z0, z1 = -1.0, -1.0 - 2 * s

    def q(*corners, **mat):
        return quad(*corners, device=device, **mat)

    walls = [
        q((-s, 0, z0), (-s, 0, z1), (-s, 2 * s, z1), (-s, 2 * s, z0),
          object_id=1, **red),                                      # left
        q((s, 0, z1), (s, 0, z0), (s, 2 * s, z0), (s, 2 * s, z1),
          object_id=2, **green),                                    # right
        q((-s, 0, z1), (-s, 0, z0), (s, 0, z0), (s, 0, z1),
          object_id=3, **white),                                    # floor
        q((-s, 2 * s, z0), (-s, 2 * s, z1), (s, 2 * s, z1), (s, 2 * s, z0),
          object_id=4, **white),                                    # ceiling
        q((-s, 0, z1), (s, 0, z1), (s, 2 * s, z1), (-s, 2 * s, z1),
          object_id=5, **white),                                    # back
        q((-0.7, 2 * s - 0.01, z0 - s + 0.7),
          (0.7, 2 * s - 0.01, z0 - s + 0.7),
          (0.7, 2 * s - 0.01, z0 - s - 0.7),
          (-0.7, 2 * s - 0.01, z0 - s - 0.7),
          emission=(12.0, 12.0, 10.0), albedo=(0, 0, 0),
          object_id=6),                                             # light
    ]
    mesh = merge_meshes(walls)

    spheres = make_scene(
        centers=[(-0.8, 0.6, z0 - s - 0.5), (0.8, 0.5, z0 - s + 0.5)],
        radii=[0.6, 0.5],
        albedos=[(0.95, 0.95, 0.95), (0.8, 0.7, 0.3)],
        metallics=[1.0, 0.0],
        roughnesses=[0.02, 0.4],
        emissions=[(0, 0, 0), (0, 0, 0)],
        background=(0.0, 0.0, 0.0),
        device=device,
    )
    return spheres, mesh


# the tie scene's camera: at the origin looking down -z, so the rays of a
# one-row frame have dy == 0 exactly and run along the triangles' shared edge
TIE_CAM = dict(position=(0.0, 0.0, 0.0), target=(0.0, 0.0, -1.0), aspect=2.0)


def tie_scene(*, device):
    """A scene whose nearest hits tie, for the cluster engine's tie rule
    (the first of equal t in the dense sweep's order wins): (spheres,
    mesh).

    One sphere twice (same centre and radius, red then green emission)
    and two triangles that share the edge y = 0, z = -5 (blue above,
    yellow below). Seven small spheres and triangles near the low corner of
    the scene's box come first in Morton order and eight near the high
    corner last, so at cluster size 8 each pair straddles two clusters;
    four large spheres and two large triangles behind the camera take the
    global slots. Through :data:`TIE_CAM`, every ray that meets the sphere
    meets both copies at the same t, and every ray of a one-row frame (v =
    0.5, so dy = 0) that meets the triangles meets the shared edge: there
    Moller-Trumbore gives both the same t (v = 0 exactly for both)."""
    from ..ops.triangle import make_mesh

    rng = np.random.default_rng(5)
    low = np.array([-40.0, -40.0, -40.0], np.float32)
    high = np.array([40.0, 40.0, 40.0], np.float32)
    centers = [(0.0, -1000.0, 0.0), (-20.0, 0.0, 50.0), (0.0, 0.0, 50.0),
               (20.0, 0.0, 50.0)]
    radii = [990.0, 6.0, 7.0, 8.0]
    emissions = [(0.0, 0.0, 0.0)] * 4
    for corner, k in ((low, 7), (high, 8)):
        for _ in range(k):
            centers.append(tuple(corner + rng.uniform(0.0, 1.0, 3)))
            radii.append(0.05)
            emissions.append((0.0, 0.0, 0.0))
    centers += [(5.0, 0.0, -9.0), (5.0, 0.0, -9.0)]
    radii += [1.5, 1.5]
    emissions += [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]
    n = len(centers)
    spheres = make_scene(
        centers=np.asarray(centers, np.float32),
        radii=np.asarray(radii, np.float32),
        albedos=np.full((n, 3), 0.6, np.float32),
        metallics=np.zeros(n, np.float32),
        roughnesses=np.full(n, 0.5, np.float32),
        emissions=np.asarray(emissions, np.float32),
        background=(0.05, 0.05, 0.1), device=device)

    verts, faces, emit = [], [], []

    def tri(a, b, c, e=(0.0, 0.0, 0.0)):
        faces.append([len(verts), len(verts) + 1, len(verts) + 2])
        verts.extend([a, b, c])
        emit.append(e)

    tri((-30.0, -30.0, 30.0), (30.0, -30.0, 30.0), (0.0, 30.0, 30.0))
    tri((-30.0, -30.0, 31.0), (30.0, -30.0, 31.0), (0.0, 30.0, 31.0))
    for corner, k in ((low, 7), (high, 8)):
        for _ in range(k):
            p = corner + rng.uniform(0.0, 1.0, 3)
            tri(tuple(p), tuple(p + (0.1, 0.0, 0.0)),
                tuple(p + (0.0, 0.1, 0.0)))
    tri((-3.0, 0.0, -5.0), (3.0, 0.0, -5.0), (0.0, 2.0, -5.0), (0, 0, 1.0))
    tri((-3.0, 0.0, -5.0), (3.0, 0.0, -5.0), (0.0, -2.0, -5.0),
        (1.0, 1.0, 0.0))
    mesh = make_mesh(np.asarray(verts, np.float32), np.asarray(faces),
                     emission=np.asarray(emit, np.float32), device=device)
    return spheres, mesh
