"""The cluster engine's walk, counted, and the IEEE square root of the
plain versions.

``vecmath.sqrt`` against numpy's correctly rounded f32 square root;
``walk_visits_reference`` (the cluster kernel's walk, near to far with the
(t, key) order, group boxes of 8 rows, any-hit shadow rays) against the
dense sweeps that define the plain version's result, on terrain and
sphere scenes; the visit counts of the plain version's
``with_visits``; and the tie scene (one sphere in two clusters, two
triangles meeting on a pixel row's rays) through the plain version and the
JAX package's ``render_cluster(..., interpret=True)``: both take the first
of equal hits in storage order (one JAX compile).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.ops import pallas_cluster as jc

import tpu_rt_torch
from tpu_rt_torch.core import scenes, vecmath
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.utils import roofline as rl

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)


def test_sqrt_is_ieee_on_two_million_values():
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.uniform(0.0, 4.0, 1_000_000),
        np.exp(rng.uniform(-87.0, 88.0, 1_000_000)),
    ]).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, 1e-45, 1e-40, 1.17549435e-38,
                        3.4028235e38, 1.0, 0.2], np.float32)
    x = np.concatenate([x, special, np.frombuffer(
        rng.integers(1, 1 << 23, 1000, dtype=np.uint32).tobytes(),
        np.float32)])  # subnormals by their bits
    ours = vecmath.sqrt(torch.from_numpy(x)).numpy()
    ref = np.sqrt(x)
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    assert np.isnan(vecmath.sqrt(torch.tensor([-1.0])).numpy()).all()
    # the two helpers built on it round as the kernels' 1.0f / sqrtf
    y = torch.from_numpy(x[:1000] + np.float32(1.0))
    np.testing.assert_array_equal(vecmath.rsqrt(y).numpy(),
                                  np.float32(1.0) / np.sqrt(y.numpy()))


def random_rays(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a few rays along the axes, where 1/d is the clamped 1e20
    d[:6] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]] * np.float32(
        [[1], [1], [1], [-1], [-1], [-1]])
    return (tuple(torch.from_numpy(o[:, i].copy()) for i in range(3)),
            tuple(torch.from_numpy(d[:, i].copy()) for i in range(3)))


def walk_scenes():
    ts, tm = scenes.terrain_mesh(n=12, seed=1, device=CPU)
    pos = torch.tensor([0.0, 6.0, 6.0])
    sp = scenes.random_spheres(300, seed=3, spread=8.0, device=CPU)
    return {
        "terrain12": (cluster.order_clusters(
            cluster.build_clusters(ts, n_active=3, cluster_size=8), pos),
            cluster.order_clusters(
                cluster.build_tri_clusters(tm, cluster_size=8), pos),
            ([-12.0, -1.5, -26.0], [12.0, 3.0, -2.0])),
        "random_spheres": (cluster.order_clusters(
            cluster.build_clusters(sp, cluster_size=8), pos), None,
            ([-9.0, -0.5, -13.0], [9.0, 3.0, 2.0])),
    }


@pytest.mark.parametrize("name", ["terrain12", "random_spheres"])
def test_walk_winners_equal_the_dense_sweep(name):
    """The walk's winner (t and key) is the dense sweep's on every ray; its
    shadow rays are occluded exactly where the dense sweep has a hit before
    t_edge."""
    cl, tri, box = walk_scenes()[name]
    o, d = random_rays(3000, 4, *box)
    t, key = cluster.dense_nearest(cl, tri, o, d)
    assert int((key >= 0).sum()) > 1000
    w = cluster.walk_visits_reference(cl, tri, o, d)
    assert torch.equal(w.t, t) and torch.equal(w.key, key)
    assert torch.equal(w.hit, key >= 0)
    # shadow rays: edges before and after the nearest hits
    t_edge = torch.where(key >= 0, t * torch.where(
        torch.arange(t.numel()) % 2 == 0, 0.999, 1.001), 7.5)
    s = cluster.walk_visits_reference(cl, tri, o, d, t_edge)
    assert torch.equal(s.hit, t < t_edge)
    assert 0 < int(s.hit.sum()) < t.numel()
    # every ray tests its globals and walks the group level; the walk tests
    # fewer primitives than the dense sweep, and the any-hit shadow rays
    # fewer than the nearest-hit search of the same rays
    G = cl.n_global + (tri.n_global if tri is not None else 0)
    assert int(w.visits[:, 4:6].sum(1).min()) >= G
    assert int(w.visits[:, 3].sum()) > 0
    rows = cluster._sweep_rows(cl).shape[0] + (
        0 if tri is None else cluster._tri_sweep_rows(tri).shape[0])
    assert int(w.visits[:, 4:6].sum()) < t.numel() * rows
    assert int(s.visits[:, 4:6].sum()) < int(w.visits[:, 4:6].sum())


def test_plain_visit_counts_and_ops():
    """render_cluster_reference(with_visits=True): the image and segments
    of the plain render, per-tile counts whose shadow kind is empty without
    NEE and the warp column -1 (no warps in the plain version); the op
    model grows with the counts."""
    ts, tm = scenes.terrain_mesh(n=12, seed=1, device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=2.0, position=(0, 6, 6),
                                   target=(0, 0, -10), device=CPU)
    kw = dict(width=128, height=64, spp=2, max_depth=3, mesh=tm,
              cluster_size=8, with_stats=True)
    img, segs = cluster.render_cluster_reference(ts, cam, 3, **kw)
    for nee in (False, True):
        a, s, vis = cluster.render_cluster_reference(
            ts, cam, 3, nee=nee, with_visits=True, **kw)
        assert vis.shape == (2, 2, 7) and vis.dtype == torch.int64
        assert bool((vis[:, :, 6] == -1).all())
        if not nee:
            assert torch.equal(a, img) and int(s) == int(segs)
            assert int(vis[:, 1, :6].abs().sum()) == 0
        else:
            assert int(vis[:, 1, 4:6].sum()) > 0
        assert int(vis[:, 0, 5].sum()) > 0
        ops = rl.cluster_walk_ops(vis)
        assert ops > rl.cluster_walk_ops(vis // 2) > 0
        full = rl.cluster_op_model(int(s), vis, 128 * 64, 2, {"nee": nee})
        assert full > ops


@pytest.fixture(scope="module")
def tie_tables():
    sp, me = scenes.tie_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(**scenes.TIE_CAM, device=CPU)
    cl = cluster.order_clusters(cluster.build_clusters(sp, cluster_size=8),
                                cam.position)
    tri = cluster.order_clusters(
        cluster.build_tri_clusters(me, cluster_size=8), cam.position)
    return cl, tri, cam


def tie_rays(cam, width):
    px = torch.arange(width, dtype=torch.float32)
    ox, oy, oz, dx, dy, dz = mk.primary_rays(
        mk._pack_camera(cam), px, torch.zeros(width),
        mk._f32(1.0 / width), mk._f32(1.0), 0, None, jitter=False,
        dof=False)
    return (ox, oy, oz), (dx, dy, dz)


def test_tie_scene_pairs_straddle_clusters_and_tie(tie_tables):
    """Each tied pair sits in two clusters, and the row's rays meet both
    members of a pair at the same t: the walk and the dense sweep take the
    member first in storage order."""
    cl, tri, cam = tie_tables
    o, d = tie_rays(cam, 256)
    assert bool((d[1] == 0).all())
    t, key = cluster.dense_nearest(cl, tri, o, d)
    w = cluster.walk_visits_reference(cl, tri, o, d)
    assert torch.equal(w.t, t) and torch.equal(w.key, key)
    rows = cluster._table_rows(cl)
    c = cluster._bits_f32(rows[:, 0:4])
    pair = [i - cl.n_global for i in range(rows.shape[0])
            if float(c[i, 0]) == 5.0 and float(c[i, 3]) == 1.5]
    trows = cluster._table_rows(tri)
    tpair = [i - tri.n_global for i in range(trows.shape[0])
             if float(cluster._bits_f32(trows[i, 2:3])) == -5.0]
    assert len(pair) == len(tpair) == 2
    assert pair[0] // 8 != pair[1] // 8 and tpair[0] // 8 != tpair[1] // 8
    on_sphere = key == ((1 << cluster.KEY_SHIFT) | pair[0])
    on_edge = key == ((3 << cluster.KEY_SHIFT) | tpair[0])
    assert int(on_sphere.sum()) > 10 and int(on_edge.sum()) > 100
    # the second member is hit at the very same t on those rays
    for tab, tri_flag, k, sel in ((cl, False, pair[1], on_sphere),
                                  (tri, True, tpair[1], on_edge)):
        rows_k = cluster._bits_f32(
            (cluster._table_rows(tab)[tab.n_global + k])[None, :9])
        oo = tuple(x[sel, None] for x in o)
        dd = tuple(x[sel, None] for x in d)
        ok, tt = (cluster._tri_hits if tri_flag
                  else cluster._sphere_hits)(oo, dd, rows_k)
        assert bool(ok.all()) and torch.equal(tt[:, 0], t[sel])


def test_tie_scene_plain_matches_jax(tie_tables):
    """The plain version and the JAX package's interpret-mode kernel,
    on the same tables, one row at depth 1 through pixel centres: bit for
    bit, the sphere's first copy and the upper triangle (first in storage)
    showing their emission."""
    cl, tri, cam = tie_tables
    kw = dict(width=256, height=1, spp=1, max_depth=1, jitter=False)
    ours = cluster.render_cluster_reference(
        None, cam, 0, prebuilt=cl, tri_prebuilt=tri, pre_ordered=True,
        **kw).numpy()

    def to_jax(tab):
        return jc.ClusteredScene(**{k: jnp.asarray(v.numpy())
                                    for k, v in tab._asdict().items()})

    jcam = tpu_rt.make_camera(**scenes.TIE_CAM)
    ref = np.asarray(jc.render_cluster(
        None, jcam, 0, interpret=True, prebuilt=to_jax(cl),
        tri_prebuilt=to_jax(tri), pre_ordered=True, cluster_size=8, **kw))
    np.testing.assert_array_equal(ours, ref)
    o, d = tie_rays(cam, 256)
    _, key = cluster.dense_nearest(cl, tri, o, d)
    em = torch.from_numpy(ours[0])
    first = {}
    for tab, cls in ((cl, 1), (tri, 3)):
        rows = cluster._table_rows(tab)
        w = 8 if cls == 1 else 14
        lo, hi = cluster._unpack_bf16_pair(rows[:, w])
        sel = (key >> cluster.KEY_SHIFT) == cls
        idx = (key[sel] & ((1 << cluster.KEY_SHIFT) - 1)) + tab.n_global
        first[cls] = (em[sel], lo[idx], hi[idx])
    # the winners' emission is what the pixels show (gamma of 0 or 1)
    for cls, (pix, lo, hi) in first.items():
        assert pix.shape[0] > 10
        np.testing.assert_array_equal(pix[:, 0].numpy(), lo.numpy())
        np.testing.assert_array_equal(pix[:, 1].numpy(), hi.numpy())
