"""The cluster engine's triangle tables and triangle search (K2-tri)
against the JAX package.

``_tri_attr_rows``, ``build_tri_clusters`` and ``order_clusters`` on
triangle tables word for word; the plain version with a mesh stream for
stream against ``render_cluster(..., mesh=, interpret=True)`` (cluster size
8, one JAX compile per depth, shared through module-scoped fixtures); and
``RayTracer.set_mesh`` past 256 triangles end to end on the CPU, with its
tables built once and ordered once per camera position. The JAX package's
``ensure_distinct_tables`` pad is a TPU workaround the port does not carry,
so the port's tables are compared with ``build_tri_clusters``' own output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core import scenes as j_scenes
from tpu_rt.ops import pallas_cluster as jc

from tpu_rt_torch.api import Material, RayTracer, Scene, Sphere, Vector3
from tpu_rt_torch.core import scenes
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.render import display, frame
from tpu_rt_torch.utils.convert import (
    camera_from_numpy, clustered_from_numpy, mesh_from_numpy)

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
TERRAIN_POSE = dict(position=(0, 6, 6), target=(0, 0, -10))


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def assert_tables_equal(ours: cluster.ClusteredScene, ref):
    for k in cluster.ClusteredScene._fields:
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def terrain12():
    """terrain_mesh(n=12, seed=1): 3 spheres, 242 triangles in a bucket of
    256, in both packages."""
    return (j_scenes.terrain_mesh(n=12, seed=1),
            scenes.terrain_mesh(n=12, seed=1, device=CPU))


def test_tri_attr_rows_match_jax(terrain12):
    """Padding and invalidated rows (zero edges) included."""
    (_, jm), (_, tm) = terrain12
    valid = np.asarray(jm.valid).copy()
    valid[::7] = False
    jm = jm._replace(valid=jnp.asarray(valid))
    tm = tm._replace(valid=torch.from_numpy(valid))
    ours = cluster._tri_attr_rows(tm)
    assert ours.dtype == torch.int32 and ours.shape == (256, 16)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jc._tri_attr_rows(jm)))


@pytest.mark.parametrize("n, C, n_active", [(12, 64, None), (24, 64, 1072),
                                            (12, 8, 242)],
                         ids=["12_C64", "24_C64_active", "12_C8_active"])
def test_build_and_order_tri_tables_word_for_word(n, C, n_active):
    _, jm = j_scenes.terrain_mesh(n=n, seed=1)
    _, tm = scenes.terrain_mesh(n=n, seed=1, device=CPU)
    ref = jc.build_tri_clusters(jm, cluster_size=C, n_active=n_active)
    ours = cluster.build_tri_clusters(tm, cluster_size=C, n_active=n_active)
    assert ours.n_global == cluster.DEFAULT_TRI_GLOBAL == 2
    assert ours.cluster_size == C and ours.attr.dtype == torch.int32
    assert ours.n_clusters == ours.n_ss * cluster.FANOUT**2
    assert_tables_equal(ours, ref)
    pos = np.array(TERRAIN_POSE["position"], np.float32)
    assert_tables_equal(
        cluster.order_clusters(ours, torch.from_numpy(pos)),
        jc.order_clusters(ref, jnp.asarray(pos)))


def test_tri_globals_are_the_largest_valid_triangles():
    """The two largest-area valid triangles go global, by a stable sort:
    with the largest invalidated, the next two take its place."""
    _, tm = scenes.cornell_box(device=CPU)
    valid = tm.valid.clone()
    valid[0] = False
    tm = tm._replace(valid=valid)
    _, jm = j_scenes.cornell_box()
    jm = jm._replace(valid=jnp.asarray(valid.numpy()))
    ours = cluster.build_tri_clusters(tm, n_active=12)
    assert_tables_equal(ours, jc.build_tri_clusters(jm, n_active=12))
    rows = cluster._tri_attr_rows(tm)
    # rows 1, 2: the left wall's second half, then the right wall's first
    np.testing.assert_array_equal(ours.glob_attr.numpy(), rows[1:3].numpy())


def test_converters_carry_tri_tables_and_meshes(terrain12):
    (_, jm), _ = terrain12
    tm = mesh_from_numpy(to_np_fields(jm), CPU)
    ref = jc.build_tri_clusters(jm)
    assert_tables_equal(cluster.build_tri_clusters(tm), ref)
    assert_tables_equal(clustered_from_numpy(to_np_fields(ref), CPU), ref)


RENDER = dict(cluster_size=8, n_active=3, n_tri_active=242)


def cameras(width, height):
    j = tpu_rt.make_camera(aspect=width / height, **TERRAIN_POSE)
    return j, camera_from_numpy(to_np_fields(j), CPU)


@pytest.fixture(scope="module")
def depth1(terrain12):
    (js, jm), (ts, tm) = terrain12
    jcam, tcam = cameras(96, 64)
    kw = dict(width=96, height=64, spp=1, max_depth=1, jitter=False)
    ref = np.asarray(jc.render_cluster(js, jcam, 0, interpret=True, mesh=jm,
                                       **kw, **RENDER))
    return ref, tcam, kw


def test_plain_depth1_bit_identical_to_jax(depth1, terrain12):
    ref, tcam, kw = depth1
    _, (ts, tm) = terrain12
    ours = cluster.render_cluster_reference(ts, tcam, 0, mesh=tm, **kw,
                                            **RENDER).numpy()
    assert ours.shape == (64, 96, 3)
    np.testing.assert_array_equal(ours, ref)


def test_plain_from_jax_tables_bit_identical(depth1, terrain12):
    """The carry-across path: JAX-built, JAX-ordered sphere and triangle
    tables rendered by the port give the same image."""
    ref, tcam, kw = depth1
    (js, jm), _ = terrain12
    pos = jnp.asarray(TERRAIN_POSE["position"], jnp.float32)
    C = RENDER["cluster_size"]
    pre = jc.order_clusters(jc.build_clusters(js, cluster_size=C,
                                              n_active=3), pos)
    tpre = jc.order_clusters(jc.build_tri_clusters(jm, cluster_size=C,
                                                   n_active=242), pos)
    ours = cluster.render_cluster_reference(
        None, tcam, 0, prebuilt=clustered_from_numpy(to_np_fields(pre), CPU),
        tri_prebuilt=clustered_from_numpy(to_np_fields(tpre), CPU),
        pre_ordered=True, **kw).numpy()
    np.testing.assert_array_equal(ours, ref)


FULL_DEPTH = dict(width=100, height=40, spp=2, max_depth=4, with_stats=True)


@pytest.fixture(scope="module")
def full_depth(terrain12):
    """Both packages' (image, segments) at FULL_DEPTH, by seed: one JAX
    interpret-mode compile serves every seed."""
    (js, jm), (ts, tm) = terrain12
    jcam, tcam = cameras(100, 40)
    out = {}

    def render(seed):
        if seed not in out:
            ref, ref_segs = jc.render_cluster(js, jcam, seed, interpret=True,
                                              mesh=jm, **FULL_DEPTH, **RENDER)
            ours, segs = cluster.render_cluster_reference(
                ts, tcam, seed, mesh=tm, **FULL_DEPTH, **RENDER)
            out[seed] = (np.asarray(ref), int(ref_segs), ours.numpy(),
                         int(segs))
        return out[seed]
    return render


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
def test_plain_matches_jax_stream_full_depth(full_depth, seed):
    """100x40 (a ragged second row of screen blocks) with jitter, 2 spp,
    depth 4 (Russian roulette), bf16-encoded triangle normals: the slack
    covers branch flips from transcendental ulps between XLA:CPU and
    torch."""
    ref, ref_segs, ours, segs = full_depth(seed)
    assert ours.shape == (40, 100, 3)
    d = np.abs(ours - ref)
    assert float((d <= 1e-4).mean()) >= 0.999
    assert abs(segs - ref_segs) <= 1e-3 * ref_segs


def test_wrapper_on_cpu_is_the_plain_version_with_a_mesh(terrain12):
    _, (ts, tm) = terrain12
    _, tcam = cameras(64, 32)
    kw = dict(width=64, height=32, spp=2, max_depth=3, with_stats=True)
    before = cluster.render_cluster.launches
    a, sa = cluster.render_cluster(ts, tcam, 11, mesh=tm, **kw)
    b, sb = cluster.render_cluster_reference(ts, tcam, 11, mesh=tm, **kw)
    assert cluster.render_cluster.launches == before
    assert torch.equal(a, b) and int(sa) == int(sb)
    # prebuilt triangle tables, ordered here or beforehand: the same image
    pre = cluster.build_tri_clusters(tm)
    c = cluster.render_cluster(ts, tcam, 11, tri_prebuilt=pre, **kw)[0]
    d = cluster.render_cluster(
        None, tcam, 11, prebuilt=cluster.order_clusters(
            cluster.build_clusters(ts), tcam.position),
        tri_prebuilt=cluster.order_clusters(pre, tcam.position),
        pre_ordered=True, **kw)[0]
    assert torch.equal(a, c) and torch.equal(a, d)


def test_all_padding_mesh_adds_nothing(terrain12):
    """A mesh with no valid triangle: every table row has zero edges, so
    the image is the spheres' alone."""
    _, (ts, tm) = terrain12
    empty = tm._replace(valid=torch.zeros_like(tm.valid))
    _, tcam = cameras(48, 32)
    kw = dict(width=48, height=32, spp=1, max_depth=3, n_active=3)
    a = cluster.render_cluster(ts, tcam, 5, mesh=empty, n_tri_active=1, **kw)
    assert torch.equal(a, cluster.render_cluster(ts, tcam, 5, **kw))


def test_render_routes_a_large_mesh_to_the_cluster_engine():
    ts, tm = scenes.terrain_mesh(n=13, seed=1, device=CPU)  # 288 triangles
    _, tcam = cameras(32, 16)
    kw = dict(width=32, height=16, spp=1, max_depth=2)
    a = frame.render(ts, tcam, 5, mesh=tm, **kw)
    b = cluster.render_cluster_reference(
        ts, tcam, 5, mesh=tm, n_active=4,
        n_tri_active=frame.quantize_count(288, 512), **kw)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tri_prebuilt"):
        frame.render(ts, tcam, 5, engine="pallas",
                     tri_prebuilt=cluster.build_tri_clusters(tm), **kw)


def terrain_api_scene(spheres) -> Scene:
    scene = Scene()
    scene.background_color = Vector3(*spheres.background.tolist())
    for i in range(int(spheres.valid.sum())):
        s = Sphere()
        s.center = Vector3(*spheres.center[i].tolist())
        s.radius = float(spheres.radius[i])
        m = Material()
        m.albedo = Vector3(*spheres.albedo[i].tolist())
        m.metallic = float(spheres.metallic[i])
        m.roughness = float(spheres.roughness[i])
        m.emission = Vector3(*spheres.emission[i].tolist())
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


def test_raytracer_set_mesh_terrain_end_to_end(monkeypatch):
    """RayTracer + set_mesh(terrain, 288 triangles): the cluster engine;
    both tables built once, ordered once per camera position; the
    accumulator equal to the same chain through the plain version."""
    calls = {"build": 0, "build_tri": 0, "order": 0}
    build, build_tri = cluster.build_clusters, cluster.build_tri_clusters
    order = cluster.order_clusters

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(cluster, "build_clusters", counted("build", build))
    monkeypatch.setattr(cluster, "build_tri_clusters",
                        counted("build_tri", build_tri))
    monkeypatch.setattr(cluster, "order_clusters", counted("order", order))
    spheres, mesh = scenes.terrain_mesh(n=13, seed=1, device=CPU)
    rt = RayTracer(seed=2, device=CPU)
    rt.set_scene(terrain_api_scene(spheres))
    assert calls == {"build": 0, "build_tri": 0, "order": 0}  # 3 spheres
    rt.set_mesh(mesh)
    assert calls == {"build": 1, "build_tri": 1, "order": 0}
    cam = rt.get_camera()
    cam.position, cam.target = (Vector3(*TERRAIN_POSE["position"]),
                                Vector3(*TERRAIN_POSE["target"]))
    rt.set_camera(cam)
    w, h, spp = 48, 32, 1
    acc, total = None, 0
    for f in range(3):
        if f == 2:
            rt.move_camera(Vector3(0.5, 0.0, 0.0))
        acc, total = frame.accumulate(acc, total,
                                      rt.render_device(w, h, spp, 3), spp)
    assert rt._last_engine == "cluster"
    assert calls == {"build": 1, "build_tri": 1, "order": 4}
    stack = display.display_stack(acc, 1.5, as_uint8=True)
    assert stack.shape == (2, h, w, 3) and stack.dtype == torch.uint8

    scene = rt._scene_arrays
    tables = build(scene, n_active=4)
    tri_tables = build_tri(mesh, n_active=frame.quantize_count(288, 512))
    acc_p, total_p = None, 0
    for f in range(3):
        cam.position.x = 0.5 if f == 2 else 0.0
        b = cluster.render_cluster_reference(
            None, cam.to_params(CPU), (3 * 1000003 + f) & 0x7FFFFFFF,
            width=w, height=h, spp=spp, max_depth=3, prebuilt=tables,
            tri_prebuilt=tri_tables)
        acc_p, total_p = frame.accumulate(acc_p, total_p, b, spp)
    assert torch.equal(acc, acc_p) and total == total_p == 3 * spp
