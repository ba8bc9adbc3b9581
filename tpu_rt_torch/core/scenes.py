"""Scene library: procedural test scenes.

Counterpart of ``tpu_rt/core/scenes.py``: ``random_spheres``, the classic
many-spheres field that drives the cluster engine past the megakernel's
64-sphere bucket. The numpy draws are the JAX package's, in the same
order, so both packages build the very same scene from one seed. The mesh
scenes (``terrain_mesh``, ``cornell_box``) wait for triangles (ROADMAP.md:
K1-tri, K2-tri).
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
