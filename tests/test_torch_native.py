"""The port's copy of the native C++ BVH (tpu_rt_torch/native): the cases
of tests/test_native.py against the scalar oracle, and its library built
into build/tpu_rt_torch/, not beside the source."""

import numpy as np
import pytest

from tpu_rt_torch import native

from oracle import scene_hit

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="g++ unavailable")


def random_scene(rng, n):
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 1.0, (n,)).astype(np.float32)
    return centers, radii


def test_library_is_built_under_build_dir():
    path = native._library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "tpu_rt_torch")
    assert not list(native._SRC.parent.glob("*.so"))


def test_build_shape_invariants(rng_np):
    centers, radii = random_scene(rng_np, 33)
    bvh = native.HostBVH.from_spheres(centers, radii)
    assert bvh.node_count <= 2 * 33 - 1
    assert sorted(bvh.order) == list(range(33))
    # the root covers everything
    lo = (centers - radii[:, None]).min(0)
    hi = (centers + radii[:, None]).max(0)
    np.testing.assert_allclose(bvh.bounds[0, :3], lo, atol=1e-5)
    np.testing.assert_allclose(bvh.bounds[0, 3:], hi, atol=1e-5)
    # the leaves' spans cover every primitive slot exactly once
    leaves = bvh.meta[bvh.meta[:, 1] > 0]
    slots = [s for first, count, _ in leaves
             for s in range(first, first + count)]
    assert sorted(slots) == list(range(33))


@pytest.mark.parametrize("n", [1, 5, 9, 64, 257])
def test_native_traversal_matches_oracle(rng_np, n):
    centers, radii = random_scene(rng_np, n)
    bvh = native.HostBVH.from_spheres(centers, radii)
    R = 300
    o = rng_np.uniform(-12, 12, (R, 3)).astype(np.float32)
    d = rng_np.normal(size=(R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t, prim = bvh.intersect_spheres(centers, radii, o, d)
    for k in range(R):
        oi, ot = scene_hit(centers.astype(float), radii.astype(float),
                           o[k].astype(float), d[k].astype(float))
        if oi is None:
            assert prim[k] == -1, f"ray {k} false hit"
        else:
            assert prim[k] == oi or abs(t[k] - ot) < 1e-3, (
                f"ray {k}: prim {prim[k]} vs {oi}")
            assert abs(t[k] - ot) < 1e-2 * max(1.0, ot)


def test_deep_tree_links_correct():
    """Trees deeper than 2 levels still find every hit (the reference's
    builder mislinked their children)."""
    n = 128
    centers = np.zeros((n, 3), np.float32)
    centers[:, 0] = np.arange(n) * 2.5
    radii = np.full((n,), 1.0, np.float32)
    bvh = native.HostBVH.from_spheres(centers, radii)
    # straight down at every sphere
    o = centers + np.array([0, 10, 0], np.float32)
    d = np.tile(np.array([[0, -1.0, 0]], np.float32), (n, 1))
    t, prim = bvh.intersect_spheres(centers, radii, o, d)
    assert (prim == np.arange(n)).all()
    np.testing.assert_allclose(t, 9.0, atol=1e-4)
