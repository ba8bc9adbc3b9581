"""The benchmark's own scene recipes: a configuration's scene as host
arrays, which the harness hands to the program (as ``api`` Scene/Sphere
objects) and to the reference alike. Frozen here so that a change to the
program's scene library cannot change what is measured."""

from __future__ import annotations

import numpy as np

FIELDS = ("center", "radius", "albedo", "metallic", "roughness", "emission",
          "ior")


def _from_rows(scene: dict) -> dict:
    cols = scene["columns"]
    rows = np.asarray(scene["rows"], np.float32).reshape(-1, len(cols))

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
            "emission": emissions, "ior": np.full((n,), 1.5, np.float32)}


RECIPES = {
    "spheres": _from_rows,
    "random_spheres": lambda s: random_spheres(
        s["n"], s["seed"], s["spread"], s["emissive_fraction"]),
}


def scene_arrays(config: dict) -> dict:
    """The configuration's scene: float32 arrays of FIELDS, one row per
    sphere, and the background (3,)."""
    scene = config["scene"]
    if scene["kind"] not in RECIPES:
        raise ValueError(f"unknown scene kind {scene['kind']!r}")
    out = RECIPES[scene["kind"]](scene)
    out["background"] = np.asarray(scene["background"], np.float32)
    return out
