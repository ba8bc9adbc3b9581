"""The cluster engine's host side and plain PyTorch version against the JAX
package.

Morton codes, the bf16-pair packing, ``build_clusters`` and
``order_clusters`` word for word; renders stream for stream against
``render_cluster(..., interpret=True)`` (the JAX kernel's interpret mode
draws from the same counter hash); the engine routing and ``RayTracer``
past 64 spheres. The CUDA kernel itself runs only on a GPU
(tests/test_torch_gpu.py, chip_smoke.py); here, the checks that need no
compiler.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core.scenes import random_spheres as j_random_spheres
from tpu_rt.ops import bvh as j_bvh
from tpu_rt.ops import pallas_cluster as jc

import tpu_rt_torch
from tpu_rt_torch.api import Material, RayTracer, Scene, Sphere, Vector3
from tpu_rt_torch.core.scenes import random_spheres
from tpu_rt_torch.ops import bvh, cluster
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.ops.triangle import quad
from tpu_rt_torch.render import display, frame
from tpu_rt_torch.utils.convert import (
    camera_from_numpy, clustered_from_numpy, scene_from_numpy)

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
CAM_POSE = dict(position=(0, 3, 14), target=(0, 0, -6))


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def cameras(width, height):
    j = tpu_rt.make_camera(aspect=width / height, **CAM_POSE)
    return j, camera_from_numpy(to_np_fields(j), CPU)


@pytest.fixture(scope="module")
def scene200():
    """random_spheres(200, seed=3) in both packages."""
    return j_random_spheres(200, seed=3), random_spheres(200, seed=3,
                                                        device=CPU)


def assert_tables_equal(ours: cluster.ClusteredScene, ref):
    for k in cluster.ClusteredScene._fields:
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.view(np.int32) if k in (
            "glob_attr", "attr") else a, b, err_msg=k)


def test_random_spheres_matches_jax(scene200):
    js, ts = scene200
    for k, v in to_np_fields(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), v, err_msg=k)


def test_morton_codes_match_jax():
    rng = np.random.default_rng(5)
    c = rng.normal(0, 20, (3000, 3)).astype(np.float32)
    valid = rng.uniform(size=3000) < 0.9
    c[~valid] = 1e9  # padding rows must not stretch the bbox
    ref = np.asarray(j_bvh.morton_codes(jnp.asarray(c), jnp.asarray(valid)))
    ours = bvh.morton_codes(torch.from_numpy(c), torch.from_numpy(valid))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
    v = torch.arange(1024)
    np.testing.assert_array_equal(
        bvh._expand_bits(v).numpy(),
        np.asarray(j_bvh._expand_bits(jnp.arange(1024))).astype(np.int64))


def test_pack_bf16_pair_matches_jax():
    rng = np.random.default_rng(9)
    a = np.concatenate([rng.normal(0, 3, 2000), [0.0, -0.0, 1e-40, -1e-42,
                        np.inf, -np.inf, np.nan, 3.4e38, 0.95, 8.0]])
    b = rng.permutation(a)
    a, b = a.astype(np.float32), b.astype(np.float32)
    ref = np.asarray(jc._pack_bf16_pair(jnp.asarray(a), jnp.asarray(b)))
    ours = cluster._pack_bf16_pair(torch.from_numpy(a), torch.from_numpy(b))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    lo, hi = cluster._unpack_bf16_pair(ours)
    fin = np.isfinite(a) & np.isfinite(b) & (np.abs(a) < 1e38) & (
        np.abs(b) < 1e38)
    np.testing.assert_allclose(lo.numpy()[fin], a[fin], rtol=4e-3, atol=1e-38)
    np.testing.assert_allclose(hi.numpy()[fin], b[fin], rtol=4e-3, atol=1e-38)


@pytest.mark.parametrize("n, seed, spread, C", [
    (200, 3, 10.0, 64),
    (5000, 2, 25.0, 8),   # third level: S = 80 supers, S2 = 10
], ids=["200_C64", "5000_C8"])
def test_build_and_order_match_jax_word_for_word(n, seed, spread, C):
    js = j_random_spheres(n, seed=seed, spread=spread)
    ts = random_spheres(n, seed=seed, spread=spread, device=CPU)
    ref = jc.build_clusters(js, cluster_size=C, n_active=n)
    ours = cluster.build_clusters(ts, cluster_size=C, n_active=n)
    assert ours.n_clusters == ours.n_supers * cluster.FANOUT
    assert ours.n_supers == ours.n_ss * cluster.FANOUT
    assert ours.cluster_size == C and ours.attr.dtype == torch.int32
    assert_tables_equal(ours, ref)
    pos = np.array(CAM_POSE["position"], np.float32)
    assert_tables_equal(
        cluster.order_clusters(ours, torch.from_numpy(pos)),
        jc.order_clusters(ref, jnp.asarray(pos)))


def test_tables_keep_denormal_words(scene200):
    """Packed words with a zero high half are f32 denormals; the tables
    stay int32 so nothing flushes them, and the converter keeps them."""
    js, ts = scene200
    ours = cluster.build_clusters(ts, n_active=200)
    words = ours.attr.numpy().ravel().view(np.uint32)
    assert ((words[words != 0] & 0x7F800000) == 0).any()
    back = clustered_from_numpy(to_np_fields(ours), CPU)
    assert_tables_equal(back, ours)


@pytest.fixture(scope="module")
def depth1_160x96(scene200):
    js, ts = scene200
    jcam, tcam = cameras(160, 96)
    ref = np.asarray(jc.render_cluster(
        js, jcam, 0, width=160, height=96, spp=1, max_depth=1, jitter=False,
        interpret=True, n_active=200))
    return ref, ts, tcam


def test_plain_depth1_bit_identical_to_jax(depth1_160x96):
    ref, ts, tcam = depth1_160x96
    ours = cluster.render_cluster_reference(
        ts, tcam, 0, width=160, height=96, spp=1, max_depth=1, jitter=False,
        n_active=200).numpy()
    assert ours.shape == (96, 160, 3)
    np.testing.assert_array_equal(ours, ref)


def test_plain_from_jax_tables_bit_identical(depth1_160x96, scene200):
    """The carry-across path: JAX-built, JAX-ordered tables rendered by the
    port give the same image."""
    ref, _, tcam = depth1_160x96
    js, _ = scene200
    pre = jc.order_clusters(jc.build_clusters(js, n_active=200),
                            jnp.asarray(CAM_POSE["position"], jnp.float32))
    tables = clustered_from_numpy(to_np_fields(pre), CPU)
    ours = cluster.render_cluster_reference(
        None, tcam, 0, width=160, height=96, spp=1, max_depth=1,
        jitter=False, prebuilt=tables, pre_ordered=True).numpy()
    np.testing.assert_array_equal(ours, ref)


FULL_DEPTH = dict(width=100, height=37, spp=2, max_depth=4, n_active=200,
                  with_stats=True)


@pytest.fixture(scope="module")
def full_depth(scene200):
    """Both packages' (image, segments) at FULL_DEPTH, by seed: one JAX
    interpret-mode compile serves every test that reads it."""
    js, ts = scene200
    jcam, tcam = cameras(100, 37)
    out = {}

    def render(seed):
        if seed not in out:
            ref, ref_segs = jc.render_cluster(js, jcam, seed, interpret=True,
                                              **FULL_DEPTH)
            ours, segs = cluster.render_cluster_reference(ts, tcam, seed,
                                                          **FULL_DEPTH)
            out[seed] = (np.asarray(ref), int(ref_segs), ours.numpy(),
                         int(segs))
        return out[seed]
    return render


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
def test_plain_matches_jax_stream_full_depth(full_depth, seed):
    """100x37 with jitter, 2 spp, depth 4 (Russian roulette), and a seed
    whose per-tile seeds wrap past 2^31. The slack covers branch flips from
    transcendental ulps between XLA:CPU and torch (sin, cos, log, exp): at
    seed 7 one path traces one segment more than in the JAX package."""
    ref, ref_segs, ours, segs = full_depth(seed)
    d = np.abs(ours - ref)
    assert float((d <= 1e-4).mean()) >= 0.999
    assert abs(segs - ref_segs) <= 1e-3 * ref_segs


def test_with_stats_ragged_frame_matches_jax(full_depth):
    """100x37 fills 1 x 2 screen blocks partly: padding lanes trace, and
    the total is scaled by 3700/8192 and truncated as in the JAX package.
    At this seed no branch flip changes a path's length, so the counts are
    equal."""
    ref, ref_segs, ours, segs = full_depth(2**31 - 2)
    assert ours.shape == (37, 100, 3)
    assert segs == ref_segs
    assert segs * 8192 % 3700 != 0  # the scaled total was truncated


def sphere_scene(n, with_ground=True):
    rng = np.random.default_rng(n)
    centers = np.c_[rng.uniform(-3, 3, n), rng.uniform(0, 1.5, n),
                    rng.uniform(-6, -1, n)]
    radii = rng.uniform(0.1, 0.4, n)
    if with_ground:
        centers[0], radii[0] = (0, -100.5, -3), 100.0
    return tpu_rt_torch.make_scene(
        centers, radii, rng.uniform(0.1, 0.9, (n, 3)),
        np.where(rng.uniform(size=n) < 0.3, 0.8, 0.0),
        rng.uniform(0, 0.5, n),
        rng.uniform(1, 5, (n, 3)) * (rng.uniform(size=(n, 1)) < 0.2),
        device=CPU)


@pytest.mark.parametrize("which", ["demo", "all_global", "padding_clusters"])
def test_cluster_depth1_matches_megakernel(which):
    """Empty padding clusters (the 9-sphere demo scene fills 5 rows of 64
    clusters) and an all-global scene (no clustered sphere at all) through
    the cluster engine: at depth 1 with pixel centres the image is the
    winner's emission or the background, which the megakernel computes
    from unpacked attributes; these emissions are exact in bf16."""
    if which == "demo":
        scene = tpu_rt_torch.demo_scene(device=CPU)
    else:
        scene = sphere_scene(3 if which == "all_global" else 40)
        em = scene.emission.to(torch.bfloat16).to(torch.float32)
        scene = scene._replace(emission=em)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    kw = dict(width=96, height=48, spp=1, max_depth=1, jitter=False)
    n = int(scene.valid.sum())
    a = cluster.render_cluster(scene, cam, 0, n_active=n, **kw)
    b = mk.render_megakernel(scene, cam, 0, n_active=n, **kw)
    assert torch.equal(a, b)
    assert cluster.build_clusters(scene, n_active=n).n_clusters == 64


def test_wrapper_on_cpu_is_the_plain_version(scene200):
    _, ts = scene200
    _, tcam = cameras(64, 32)
    kw = dict(width=64, height=32, spp=2, max_depth=3, n_active=200,
              with_stats=True)
    before = cluster.render_cluster.launches
    a, sa = cluster.render_cluster(ts, tcam, 11, **kw)
    b, sb = cluster.render_cluster_reference(ts, tcam, 11, **kw)
    assert cluster.render_cluster.launches == before
    assert torch.equal(a, b) and int(sa) == int(sb)
    # prebuilt tables, ordered here or beforehand, render the same image
    pre = cluster.build_clusters(ts, n_active=200)
    c = cluster.render_cluster(None, tcam, 11, prebuilt=pre, **kw)[0]
    d = cluster.render_cluster(
        None, tcam, 11, prebuilt=cluster.order_clusters(pre, tcam.position),
        pre_ordered=True, **kw)[0]
    assert torch.equal(a, c) and torch.equal(a, d)


def test_select_engine_routes_past_64_spheres():
    assert frame.select_engine(sphere_scene(64)) == "pallas"
    assert frame.select_engine(sphere_scene(65)) == "cluster"
    demo = tpu_rt_torch.demo_scene(device=CPU)
    assert frame.select_engine(demo, engine="cluster") == "cluster"
    # linear output with engine="auto": the JAX package's lax engine
    assert frame.select_engine(sphere_scene(65), gamma=False) == "lax"


def test_render_routes_to_cluster_engine():
    scene = sphere_scene(65)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    kw = dict(width=32, height=16, spp=1, max_depth=2)
    a = frame.render(scene, cam, 5, **kw)
    b = cluster.render_cluster_reference(
        scene, cam, 5, n_active=frame.quantize_count(65, 128), **kw)
    assert torch.equal(a, b)


MASK = torch.ones(1, dtype=torch.int32)
CLUSTER_FLAGS = {
    # refraction, DOF, stratify, NEE and linear output render
    # (tests/test_torch_flags_cluster.py, test_torch_nee.py), and so do they
    # under a tile mask or in bands: an all-ones mask renders what no mask
    # does, and a band of 32 rows is those rows of the full frame
    "refraction": (dict(enable_refraction=True, tile_mask=MASK), "mask"),
    "dof": (dict(enable_dof=True, tile_mask=MASK), "mask"),
    "linear": (dict(gamma=False, rows=32), "band"),
    # a mesh renders (tests/test_torch_cluster_tri.py), masked too
    "mesh": (dict(mesh=quad((-1, 0, -2), (1, 0, -2), (1, 1, -2), (-1, 1, -2),
                            device=CPU), tile_mask=MASK), "mask"),
    "nee": (dict(nee=True, tile_mask=MASK), "mask"),
    "stratify": (dict(stratify=True, nee=True, rows=32), "band"),
    "tile_mask": (dict(tile_mask=torch.ones(1, dtype=torch.int32)), "mask"),
    "rows": (dict(rows=32), "band"),
    # a band past the frame's last row
    "row_offset": (dict(row_offset=32), ValueError),
}


@pytest.mark.parametrize("name", list(CLUSTER_FLAGS))
def test_unported_flags_raise(name):
    """The tile mask and bands raised until they were ported; now an
    all-ones mask equals the unmasked render (through render_cluster and
    render), the bands [0, 32) and [32, 64) equal those rows of the full
    frame with their segment counts adding up, and a band outside the
    frame raises ValueError."""
    kw, holds = CLUSTER_FLAGS[name]
    scene = sphere_scene(70)
    cam = tpu_rt_torch.make_camera(device=CPU)
    args = dict(width=16, height=8, spp=1, max_depth=1, with_stats=True)
    if holds == "mask":
        unmasked = {k: v for k, v in kw.items() if k != "tile_mask"}
        for fn in (cluster.render_cluster, frame.render):
            a, sa = fn(scene, cam, 0, **args, **kw)
            b, sb = fn(scene, cam, 0, **args, **unmasked)
            assert torch.equal(a, b) and int(sa) == int(sb) > 0
    elif holds == "band":
        # whole screen blocks: the segment totals need no scaling
        args.update(width=128, height=64)
        full, s_full = cluster.render_cluster(
            scene, cam, 0, **args, **{k: v for k, v in kw.items()
                                      if k != "rows"})
        top, s_top = cluster.render_cluster(scene, cam, 0, **args, **kw)
        low, s_low = cluster.render_cluster(scene, cam, 0, row_offset=32,
                                            **args, **kw)
        assert top.shape == low.shape == (32, 128, 3)
        assert torch.equal(torch.cat([top, low]), full)
        assert int(s_top) + int(s_low) == int(s_full)
    else:
        with pytest.raises(holds, match="band"):
            cluster.render_cluster(scene, cam, 0, **args, **kw)


def api_scene(n):
    rng = np.random.default_rng(70)
    scene = Scene()
    scene.background_color = Vector3(0.3, 0.4, 0.6)
    for i in range(n):
        s = Sphere()
        if i == 0:
            s.center, s.radius = Vector3(0, -100.5, -3), 100.0
        else:
            s.center = Vector3(*rng.uniform([-3, 0, -6], [3, 1.5, -1]))
            s.radius = float(rng.uniform(0.1, 0.4))
        m = Material()
        m.albedo = Vector3(*rng.uniform(0.1, 0.9, 3))
        m.metallic = 0.8 if i % 4 == 1 else 0.0
        m.emission = Vector3(4, 4, 3) if i % 9 == 2 else Vector3()
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


def test_raytracer_70_spheres_end_to_end(monkeypatch):
    """RayTracer on a 70-sphere scene: the cluster engine, tables built at
    set_scene and ordered once per camera position, to a uint8 stack equal
    to the same chain through the plain version."""
    calls = {"build": 0, "order": 0}
    build, order = cluster.build_clusters, cluster.order_clusters

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cluster, "build_clusters", counted("build", build))
    monkeypatch.setattr(cluster, "order_clusters", counted("order", order))
    rt = RayTracer(seed=2, device=CPU)
    rt.set_scene(api_scene(70))
    assert calls == {"build": 1, "order": 0}
    w, h, spp = 64, 32, 2
    acc, total = None, 0
    for f in range(3):
        if f == 2:
            rt.move_camera(Vector3(0.25, 0.0, 0.0))
        batch = rt.render_device(w, h, spp, 3)
        acc, total = frame.accumulate(acc, total, batch, spp)
    stack = display.display_stack(acc, 1.5, as_uint8=True)
    assert rt._last_engine == "cluster"
    assert calls == {"build": 1, "order": 2}
    assert stack.shape == (2, h, w, 3) and stack.dtype == torch.uint8

    scene = api_scene(70).to_arrays(device=CPU)
    tables = build(scene, n_active=frame.quantize_count(70, 128))
    acc_p, total_p = None, 0
    cam_api = rt.get_camera()
    for f in range(3):
        cam_api.position.x = 0.25 if f == 2 else 0.0
        b = cluster.render_cluster_reference(
            None, cam_api.to_params(CPU), (3 * 1000003 + f) & 0x7FFFFFFF,
            width=w, height=h, spp=spp, max_depth=3, prebuilt=tables)
        acc_p, total_p = frame.accumulate(acc_p, total_p, b, spp)
    assert torch.equal(acc, acc_p) and total == total_p == 3 * spp
    assert torch.equal(stack, display.display_stack(acc_p, 1.5,
                                                    as_uint8=True))


def test_cuda_source_constants_match_python():
    """The kernel cannot run here; its screen-block shape, fanout, global
    table size and exported signature must be the ones the wrapper uses."""
    from tpu_rt_torch.kernels import build

    csrc = os.path.join(os.path.dirname(cluster.__file__), os.pardir, "csrc")
    src = open(os.path.join(csrc, "cluster.cu")).read()
    common = open(os.path.join(csrc, "path_common.cuh")).read()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const("kSublanes") == cluster.SUBLANES
    assert const("kLanes") == cluster.LANES
    assert const("kFanout") == cluster.FANOUT
    assert const("kMaxGlobal") == cluster.MAX_GLOBAL
    assert const("kTile", common) == cluster.TILE
    assert const("kRRStart", common) == mk.RR_START
    assert "2654435769u" in src  # the seed multiplier of the hash mix
    sig = re.search(r"int tpurt_cluster_launch\(([^)]*)\)", src)[1]
    assert len(sig.split(",")) == len(build.SIGNATURES["tpurt_cluster_launch"])
