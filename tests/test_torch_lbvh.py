"""The port's LBVH (tpu_rt_torch/ops/bvh.py, the mesh half of
ops/triangle.py) against the JAX package's on the CPU: the DFS layout, the
built boxes and leaf order, and the closest hits of spheres and triangles
through the lockstep skip-link traversal, equal to JAX's and to the port's
dense sweeps, at two scene sizes; the traversal against the copied native
C++ BVH (an independent oracle); the selection raycast against JAX's."""

import numpy as np
import pytest
import torch

import jax
from tpu_rt.core import scenes as j_scenes
from tpu_rt.ops import bvh as j_bvh
from tpu_rt.ops import intersect as j_intersect
from tpu_rt.ops import triangle as j_triangle

from tpu_rt_torch import native
from tpu_rt_torch.ops import bvh, intersect, triangle
from tpu_rt_torch.utils.convert import mesh_from_numpy, scene_from_numpy

# six xdist workers share the CPU: one intra-op thread each
torch.set_num_threads(1)
CPU = torch.device("cpu")
R = 256
# (spheres, sphere seed, terrain n): 100 spheres beside 242 triangles, and
# 700 beside 1058
SIZES = {"small": (100, 3, 12), "large": (700, 4, 24)}


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _rays(seed):
    """Rays from a shell of radius 25 towards points of the scene's box."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(R, 3))
    o = (25.0 * o / np.linalg.norm(o, axis=-1, keepdims=True))
    tgt = r.uniform(-8.0, 8.0, (R, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


_CACHE = {}


def _case(size):
    """Both packages' scene, mesh, LBVHs, rays, and JAX's hits through one
    jitted call (one JAX compile per size)."""
    if size in _CACHE:
        return _CACHE[size]
    n, seed, tn = SIZES[size]
    js = j_scenes.random_spheres(n, seed=seed)
    _, jm = j_scenes.terrain_mesh(n=tn, seed=1)
    ts, tm = scene_from_numpy(_np(js), CPU), mesh_from_numpy(_np(jm), CPU)
    o, d = _rays(seed)

    @jax.jit
    def jax_hits(js, jm, o, d):
        sb, mb = j_bvh.scene_lbvh(js), j_triangle.mesh_lbvh(jm)
        return (j_bvh.intersect_spheres_bvh_hit(js, sb, o, d),
                j_triangle.intersect_mesh_bvh_hit(jm, mb, o, d))

    jh = jax.tree_util.tree_map(np.asarray, jax_hits(js, jm, o, d))
    _CACHE[size] = (js, jm, ts, tm, o, d, jh)
    return _CACHE[size]


def _assert_hits_equal(h, ref, tol, normal_tol=None, hits_only=False):
    """The same primitive per ray (hit flags and object ids equal), the
    float fields within ``tol`` (relative, and absolute near 0), the
    normal within ``normal_tol`` (a sphere's normal scales the hit point's
    error by 1 / radius); with ``hits_only`` the attributes only where a
    ray hit (the dense sweep fetches zeros on a miss, the BVH primitive
    0's)."""
    keep = h.hit.numpy() if hits_only else slice(None)
    for name in h._fields:
        a = getattr(h, name).numpy()[keep]
        b = np.asarray(getattr(ref, name))[keep]
        assert a.shape == b.shape, name
        if a.dtype == bool or name == "object_id":
            assert np.array_equal(a, b), name
        else:
            t = normal_tol if name == "normal" and normal_tol else tol
            np.testing.assert_allclose(a, b, rtol=t, atol=t, err_msg=name)


@pytest.mark.parametrize("n_leaves", [1, 2, 16, 64, 1024])
def test_dfs_layout_equals_jax(n_leaves):
    ours, ref = bvh.dfs_layout(n_leaves), j_bvh._dfs_layout(n_leaves)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert bvh.dfs_layout(n_leaves) is ours  # cached per leaf count


@pytest.mark.parametrize("size", list(SIZES))
def test_build_lbvh_equals_jax(size):
    js, jm, ts, tm, *_ = _case(size)
    for ours, ref in ((bvh.scene_lbvh(ts), j_bvh.scene_lbvh(js)),
                      (triangle.mesh_lbvh(tm), j_triangle.mesh_lbvh(jm))):
        for name in bvh.LBVH._fields:
            a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("size", list(SIZES))
def test_bvh_hits_equal_jax_and_dense_sweeps(size):
    _, _, ts, tm, o, d, (j_sph, j_tri) = _case(size)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    sph = bvh.intersect_spheres_bvh_hit(ts, bvh.scene_lbvh(ts), to, td)
    tri = triangle.intersect_mesh_bvh_hit(tm, triangle.mesh_lbvh(tm), to, td)
    # XLA:CPU contracts the quadratic's sums into FMAs, which the
    # discriminant's cancellation (origins 25 away) carries to t: measured
    # at most 3.9e-5 relative, the normal 4.7e-4 (spheres of radius 0.1);
    # the primitives are the same
    _assert_hits_equal(sph, j_sph, 1e-4, normal_tol=2e-3)
    _assert_hits_equal(tri, j_tri, 1e-4)
    assert 0 < int(sph.hit.sum()) < R and 0 < int(tri.hit.sum()) < R
    # the dense sweeps find the same primitives at the same t (the sweep
    # solves the winner's t in the same oc-form)
    assert torch.equal(sph.hit, intersect.intersect_brute(ts, to, td).hit)
    _assert_hits_equal(sph, intersect.intersect_brute(ts, to, td), 1e-6,
                       hits_only=True)
    _assert_hits_equal(tri, triangle.intersect_mesh_brute(tm, to, td), 1e-4,
                       hits_only=True)
    t, prim = bvh.intersect_spheres_bvh(ts, bvh.scene_lbvh(ts), to, td)
    assert torch.equal(t, sph.t)
    assert torch.equal(prim >= 0, sph.hit)


@pytest.mark.skipif(not native.available(), reason="g++ unavailable")
@pytest.mark.parametrize("size", list(SIZES))
def test_traversal_matches_native_oracle(size):
    _, _, ts, _, o, d, _ = _case(size)
    centers = ts.center.numpy()[ts.valid.numpy()]
    radii = ts.radius.numpy()[ts.valid.numpy()]
    host = native.HostBVH.from_spheres(centers, radii)
    nt, nprim = host.intersect_spheres(centers, radii, o, d)
    t, prim = bvh.intersect_spheres_bvh(
        ts, bvh.scene_lbvh(ts), torch.from_numpy(o), torch.from_numpy(d))
    t, prim = t.numpy(), prim.numpy()
    assert np.array_equal(prim >= 0, nprim >= 0)
    hit = prim >= 0
    assert np.array_equal(prim[hit], nprim[hit])
    # the C++ oracle rounds its own quadratic: measured 1.2e-5 relative
    np.testing.assert_allclose(t[hit], nt[hit], rtol=1e-4)


@pytest.mark.parametrize("skip", [None, 0])
def test_closest_object_id_equals_jax(skip):
    js = j_scenes.random_spheres(40, seed=5)
    ts = scene_from_numpy(_np(js), CPU)
    o, d = _rays(5)
    ours = [int(intersect.closest_object_id(
        ts, torch.from_numpy(o[i]), torch.from_numpy(d[i]),
        skip_object_id=skip)) for i in range(24)]
    ref = [int(j_intersect.closest_object_id(js, o[i], d[i],
                                             skip_object_id=skip))
           for i in range(24)]
    assert ours == ref and any(x >= 0 for x in ours) and -1 in ours
