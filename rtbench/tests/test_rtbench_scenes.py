"""The benchmark's scene recipes build what the program's scene library
builds for the same arguments, bit for bit (the recipes import nothing of
the program; these tests compare them with it)."""

import numpy as np
import pytest
import torch

from rtbench import harness, scenes

# the Cornell box of core/scenes.py:cornell_box as an inline scene
S, Z0 = 2.0, -1.0
Z1 = Z0 - 2 * S
WHITE = (0.73, 0.73, 0.73)
CORNELL = {
    "kind": "triangles",
    "background": [0.0, 0.0, 0.0],
    "spheres": {
        "columns": ["cx", "cy", "cz", "radius", "ar", "ag", "ab", "metallic",
                    "roughness", "er", "eg", "eb", "ior"],
        "rows": [[-0.8, 0.6, Z0 - S - 0.5, 0.6, 0.95, 0.95, 0.95, 1.0, 0.02,
                  0, 0, 0, 1.5],
                 [0.8, 0.5, Z0 - S + 0.5, 0.5, 0.8, 0.7, 0.3, 0.0, 0.4,
                  0, 0, 0, 1.5]]},
    "faces": [
        {"quad": [[-S, 0, Z0], [-S, 0, Z1], [-S, 2 * S, Z1], [-S, 2 * S, Z0]],
         "albedo": [0.65, 0.05, 0.05], "object_id": 1},
        {"quad": [[S, 0, Z1], [S, 0, Z0], [S, 2 * S, Z0], [S, 2 * S, Z1]],
         "albedo": [0.12, 0.45, 0.15], "object_id": 2},
        {"quad": [[-S, 0, Z1], [-S, 0, Z0], [S, 0, Z0], [S, 0, Z1]],
         "albedo": WHITE, "object_id": 3},
        {"quad": [[-S, 2 * S, Z0], [-S, 2 * S, Z1], [S, 2 * S, Z1],
                  [S, 2 * S, Z0]], "albedo": WHITE, "object_id": 4},
        {"quad": [[-S, 0, Z1], [S, 0, Z1], [S, 2 * S, Z1], [-S, 2 * S, Z1]],
         "albedo": WHITE, "object_id": 5},
        {"quad": [[-0.7, 2 * S - 0.01, Z0 - S + 0.7],
                  [0.7, 2 * S - 0.01, Z0 - S + 0.7],
                  [0.7, 2 * S - 0.01, Z0 - S - 0.7],
                  [-0.7, 2 * S - 0.01, Z0 - S - 0.7]],
         "emission": [12.0, 12.0, 10.0], "albedo": [0, 0, 0],
         "object_id": 6},
    ],
}


def _same_spheres(arrays, scene):
    n = arrays["radius"].shape[0]
    assert int(scene.valid.sum()) == n
    for name in ("center", "radius", "albedo", "metallic", "roughness",
                 "emission", "ior"):
        assert torch.equal(torch.from_numpy(arrays[name]),
                           getattr(scene, name)[:n]), name
    assert torch.equal(torch.from_numpy(arrays["background"]),
                       scene.background)


def _same_mesh(arrays, mesh, rows=None):
    """The harness's mesh of ``arrays`` is ``mesh``, field by field, over
    its first ``rows`` rows (default: all, padding included)."""
    built = harness.build_mesh(arrays["mesh"], "cpu")
    assert built.capacity == mesh.capacity
    for name in mesh._fields:
        assert torch.equal(getattr(built, name)[:rows],
                           getattr(mesh, name)[:rows]), name


@pytest.mark.parametrize("n,extent,seed", [(8, 12.0, 0), (13, 12.0, 1),
                                           (72, 12.0, 1), (24, 6.5, 3)])
def test_terrain_recipe_is_the_program_terrain(n, extent, seed):
    from tpu_rt_torch.core.scenes import terrain_mesh

    arrays = scenes.scene_arrays({"scene": {"kind": "terrain", "n": n,
                                            "extent": extent, "seed": seed}})
    spheres, mesh = terrain_mesh(n=n, extent=extent, seed=seed, device="cpu")
    assert arrays["mesh"]["vertices"].shape == (2 * (n - 1) ** 2, 3, 3)
    _same_spheres(arrays, spheres)
    _same_mesh(arrays, mesh)


def test_triangles_recipe_is_the_program_cornell_box():
    from tpu_rt_torch.core.scenes import cornell_box

    arrays = scenes.scene_arrays({"scene": CORNELL})
    spheres, mesh = cornell_box(device="cpu")
    assert arrays["mesh"]["vertices"].shape == (12, 3, 3)
    _same_spheres(arrays, spheres)
    # merge_meshes pads ior with 0, make_mesh with 1.5: padding rows have
    # zero edges and are never hit
    _same_mesh(arrays, mesh, rows=12)
    assert not harness.build_mesh(arrays["mesh"], "cpu").valid[12:].any()


def test_a_triangle_row_and_the_defaults():
    arrays = scenes.scene_arrays({"scene": {
        "kind": "triangles", "background": [0.1, 0.2, 0.3],
        "spheres": dict(CORNELL["spheres"], rows=[]),
        "faces": [{"triangle": [[0, 0, 0], [1, 0, 0], [0, 1, 0]]},
                  {"quad": [[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
                   "roughness": 0.25, "object_id": 7}]}})
    mesh = arrays["mesh"]
    assert arrays["radius"].shape == (0,)
    assert mesh["vertices"].shape == (3, 3, 3)
    assert mesh["vertices"][2].tolist() == [[0, 0, 1], [1, 1, 1], [0, 1, 1]]
    assert mesh["albedo"].tolist() == [[np.float32(0.8)] * 3] * 3
    assert mesh["roughness"].tolist() == [0.5, 0.25, 0.25]
    assert mesh["object_id"].dtype == np.int32
    assert mesh["object_id"].tolist() == [0, 7, 7]


def test_random_spheres_recipe_is_the_program_field():
    from tpu_rt_torch.core.scenes import random_spheres

    arrays = scenes.scene_arrays({"scene": {
        "kind": "random_spheres", "n": 300, "seed": 4, "spread": 9.0,
        "emissive_fraction": 0.2, "background": [0.3, 0.4, 0.6]}})
    assert arrays["mesh"] is None
    _same_spheres(arrays, random_spheres(300, seed=4, spread=9.0,
                                         emissive_fraction=0.2, device="cpu"))
