"""Next-event estimation (NEE) and linear output in the plain versions of
both kernels against the JAX package.

The plain versions with ``nee=True, gamma=False`` stream for stream against
``render_pallas``/``render_cluster(..., nee=True, gamma=False,
interpret=True)`` in four configurations (one JAX compile each, shared
across seeds through a module-scoped fixture): the blocker scene of
``tests/test_nee.py`` through the megakernel and the cluster engine, the
Cornell box with an emissive sphere under its ceiling (its walls occlude the
shadow rays) through the megakernel, and the blocker scene with a quad
occluder through the cluster engine at cluster size 8. Beside them: the
light cdf and light table word for word against the JAX package's lines,
``render``, ``RayTracer`` and ``display_stack`` with NEE and linear output
on the CPU. The CUDA kernels run on a GPU only (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core import scenes as j_scenes
from tpu_rt.ops import pallas_cluster as jc
from tpu_rt.ops import pallas_megakernel as j_mk
from tpu_rt.ops import triangle as j_tri
from tpu_rt.render import display as j_display

import tpu_rt_torch
from tpu_rt_torch.api import RayTracer
from tpu_rt_torch.app import run as app_run
from tpu_rt_torch.core import vecmath
from tpu_rt_torch.core.scenes import cornell_box
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.ops import triangle as tri
from tpu_rt_torch.render import display, frame
from tpu_rt_torch.utils.convert import camera_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
W, H = 100, 40
NEE_POSE = dict(position=(0, 1.0, 2.0), target=(0, 0.2, -3))
CORNELL_POSE = dict(position=(0, 2, 2.5), target=(0, 2, -3))
# a quad between the light of the blocker scene and the balls
OCCLUDER = ((-1.4, 1.9, -2.0), (-0.4, 1.9, -2.0), (-0.4, 1.9, -3.2),
            (-1.4, 1.9, -3.2))


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def blocker_rows():
    """``tests/test_nee.py:nee_scene(blocker=True)``: ground, a diffuse
    ball, a rough metal ball, one small bright light and an opaque sphere
    between the light and the diffuse ball."""
    return dict(
        centers=[(0, -100.5, -3), (0, 0.2, -3), (1.2, 0.2, -3),
                 (-1.0, 2.5, -2.5), (-0.5, 1.3, -2.75)],
        radii=[100.0, 0.7, 0.5, 0.35, 0.45],
        albedos=[(0.6, 0.6, 0.6), (0.7, 0.3, 0.3), (0.8, 0.8, 0.4),
                 (1.0, 1.0, 1.0), (0.2, 0.2, 0.2)],
        metallics=[0.0, 0.0, 1.0, 0.0, 0.0],
        roughnesses=[0.5, 0.5, 0.4, 0.0, 0.5],
        emissions=[(0, 0, 0), (0, 0, 0), (0, 0, 0), (14.0, 12.0, 10.0),
                   (0, 0, 0)],
        background=(0.0, 0.0, 0.0))


def bulb_rows():
    """The Cornell box's two spheres and an emissive bulb under its
    ceiling."""
    return dict(
        centers=[(-0.8, 0.6, -3.5), (0.8, 0.5, -2.5), (0.0, 3.3, -3.0)],
        radii=[0.6, 0.5, 0.25],
        albedos=[(0.95, 0.95, 0.95), (0.8, 0.7, 0.3), (1.0, 1.0, 1.0)],
        metallics=[1.0, 0.0, 0.0],
        roughnesses=[0.02, 0.4, 0.0],
        emissions=[(0, 0, 0), (0, 0, 0), (10.0, 9.0, 8.0)],
        background=(0.0, 0.0, 0.0))


def both_scenes(rows):
    return (tpu_rt.make_scene(**rows),
            tpu_rt_torch.make_scene(**rows, device=CPU))


def both_cams(pose, **kw):
    jcam = tpu_rt.make_camera(aspect=W / H, **pose, **kw)
    return jcam, camera_from_numpy(to_np_fields(jcam), CPU)


CONFIGS = {
    # (a) the blocker scene through the megakernel
    "k1_blocker": dict(engine="k1", rows=blocker_rows, pose=NEE_POSE,
                       mesh=None, kw=dict(n_active=8)),
    # (b) the Cornell box with a bulb: the walls occlude its shadow rays;
    # with refraction (its salt precedes NEE's) and the R2 lattice
    "k1_cornell_bulb": dict(engine="k1", rows=bulb_rows, pose=CORNELL_POSE,
                            mesh="cornell",
                            kw=dict(n_active=4, n_tri_active=12,
                                    enable_refraction=True, stratify=True)),
    # (c) the blocker scene through the cluster engine
    "k2_blocker": dict(engine="k2", rows=blocker_rows, pose=NEE_POSE,
                       mesh=None, kw=dict(n_active=8, cluster_size=8)),
    # (d) ... with a quad occluder (triangle globals)
    "k2_quad": dict(engine="k2", rows=blocker_rows, pose=NEE_POSE,
                    mesh="quad", kw=dict(n_active=8, cluster_size=8)),
}


@pytest.fixture(scope="module")
def nee_streams():
    """Both packages' linear (image, segments) for a config and seed: the
    seed is traced, so one JAX interpret-mode compile serves both seeds."""
    out = {}

    def render(name, seed):
        if (name, seed) not in out:
            cfg = CONFIGS[name]
            js, ts = both_scenes(cfg["rows"]())
            jcam, tcam = both_cams(cfg["pose"])
            jm = tm = None
            if cfg["mesh"] == "cornell":
                jm = j_scenes.cornell_box()[1]
                tm = cornell_box(device=CPU)[1]
            elif cfg["mesh"] == "quad":
                jm = j_tri.quad(*OCCLUDER, albedo=(0.5, 0.5, 0.5))
                tm = tri.quad(*OCCLUDER, albedo=(0.5, 0.5, 0.5), device=CPU)
            kw = dict(width=W, height=H, spp=2, max_depth=4, nee=True,
                      gamma=False, with_stats=True, **cfg["kw"])
            if cfg["engine"] == "k1":
                ref, ref_segs = j_mk.render_pallas(js, jcam, seed, mesh=jm,
                                                   interpret=True, **kw)
                ours, segs = mk.render_megakernel_reference(ts, tcam, seed,
                                                            mesh=tm, **kw)
            else:
                ref, ref_segs = jc.render_cluster(js, jcam, seed, mesh=jm,
                                                  interpret=True, **kw)
                ours, segs = cluster.render_cluster_reference(
                    ts, tcam, seed, mesh=tm, **kw)
            out[name, seed] = (np.asarray(ref), int(ref_segs), ours.numpy(),
                               int(segs))
        return out[name, seed]
    return render


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_matches_jax_kernels_with_nee(nee_streams, name, seed):
    """100x40 with jitter, 2 spp, depth 4, linear output: the tolerances of
    the flag streams (branch flips from transcendental ulps between XLA:CPU
    and torch); the shadow segments count as the JAX kernels count them."""
    ref, ref_segs, ours, segs = nee_streams(name, seed)
    assert ours.shape == (H, W, 3) and float(ours.max()) > 0.0
    d = np.abs(ours - ref)
    assert float((d <= 1e-4).mean()) >= 0.999
    assert abs(segs - ref_segs) <= 1e-3 * ref_segs


def test_nee_changes_the_image_and_adds_shadow_segments():
    """NEE adds one segment per diffuse hit and brightens the lit ground
    as an estimate of the same light."""
    _, ts = both_scenes(blocker_rows())
    _, tcam = both_cams(NEE_POSE)
    kw = dict(width=W, height=H, spp=2, max_depth=4, n_active=8,
              with_stats=True, gamma=False)
    a, sa = mk.render_megakernel_reference(ts, tcam, 3, nee=True, **kw)
    b, sb = mk.render_megakernel_reference(ts, tcam, 3, **kw)
    assert int(sa) > int(sb) and not torch.equal(a, b)


def jax_light_cdf(sc):
    """tpu_rt/ops/pallas_megakernel.py:882-887, re-run here."""
    em_max = jnp.max(sc.emission, axis=-1)
    is_light = sc.valid & (em_max > 0.0) & (sc.radius > 0.0)
    lw = is_light.astype(jnp.float32)
    n_lights = jnp.sum(lw)
    return jnp.cumsum(lw) / jnp.maximum(n_lights, 1.0), n_lights


def jax_light_table(sc, n_lights_max=8):
    """tpu_rt/ops/pallas_cluster.py:1745-1754, re-run here."""
    em_max = jnp.max(sc.emission, axis=-1)
    is_light = sc.valid & (em_max > 0.0) & (sc.radius > 0.0)
    order = jnp.argsort(~is_light, stable=True)  # lights first
    idx = order[:n_lights_max]
    lw = is_light[idx].astype(jnp.float32)
    n_lights = jnp.sum(lw)
    cdf = jnp.cumsum(lw) / jnp.maximum(n_lights, 1.0)
    lights = jnp.concatenate(
        [sc.center[idx], sc.radius[idx, None] * lw[:, None],
         sc.emission[idx], cdf[:, None]], axis=-1).reshape(-1)
    return lights, n_lights


def lit_rows(n, n_lit, seed):
    """n random spheres of which ``n_lit`` (at random indices) emit."""
    rng = np.random.default_rng(seed)
    em = np.zeros((n, 3), np.float32)
    em[rng.choice(n, n_lit, replace=False)] = rng.uniform(1, 9, (n_lit, 3))
    return dict(centers=rng.uniform(-5, 5, (n, 3)).astype(np.float32),
                radii=rng.uniform(0.2, 1.0, n).astype(np.float32),
                albedos=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                metallics=np.zeros(n, np.float32),
                roughnesses=np.full(n, 0.5, np.float32), emissions=em)


@pytest.mark.parametrize("n_lit", [3, 12])
def test_light_tables_match_jax_word_for_word(n_lit):
    """The K1 light cdf and the K2 light table (past the cap of 8 with 12
    lights: the first 8 by index) are the JAX package's, bit for bit."""
    js, ts = both_scenes(lit_rows(20, n_lit, n_lit))
    cdf, n_lights = jax_light_cdf(js)
    ours = mk.light_cdf(ts).numpy()
    assert np.array_equal(ours, np.append(np.asarray(cdf),
                                          np.float32(n_lights)))
    lights, n_lights = jax_light_table(js)
    table = cluster.light_table(ts).numpy()
    assert np.array_equal(table, np.append(np.asarray(lights),
                                           np.float32(n_lights)))
    assert table[-1] == min(n_lit, 8) and table.shape == (8 * 8 + 1,)


def test_light_table_holds_the_scene_bucket_and_bounds():
    """A bucket smaller than n_lights_max gives one row per sphere; the
    kernel's shared table takes at most MAX_LIGHTS rows."""
    ts = tpu_rt_torch.make_scene(**lit_rows(3, 2, 1), capacity=4,
                                 device=CPU)
    assert ts.capacity == 4
    assert cluster.light_table(ts).shape == (8 * ts.capacity + 1,)
    with pytest.raises(ValueError):
        cluster.light_table(ts, cluster.MAX_LIGHTS + 1)


def test_render_routes_nee_and_linear_output():
    """``render(nee=True)`` reaches both engines; ``gamma=False`` renders
    through an engine named, and with engine="auto" through the lax
    engine, as in the JAX package."""
    _, ts = both_scenes(blocker_rows())
    _, tcam = both_cams(NEE_POSE)
    kw = dict(width=32, height=16, spp=1, max_depth=3)
    a = frame.render(ts, tcam, 5, nee=True, **kw)
    assert torch.equal(a, mk.render_megakernel_reference(
        ts, tcam, 5, n_active=8, nee=True, **kw))
    b = frame.render(ts, tcam, 5, nee=True, gamma=False, engine="cluster",
                     **kw)
    assert torch.equal(b, cluster.render_cluster_reference(
        ts, tcam, 5, n_active=8, nee=True, gamma=False, **kw))
    c = frame.render(ts, tcam, 5, gamma=False, engine="pallas", **kw)
    assert torch.equal(c, mk.render_megakernel_reference(
        ts, tcam, 5, n_active=8, gamma=False, **kw))
    d = frame.render(ts, tcam, 5, gamma=False, **kw)
    assert torch.equal(d, frame.render(ts, tcam, 5, gamma=False,
                                       engine="lax", **kw))
    assert d.shape == c.shape and not torch.equal(d, c)


def test_linear_output_is_the_mean_before_gamma():
    """Both engines' gamma'd output is the clamped sqrt of their linear
    output, value for value (the correctly rounded sqrt the port takes,
    vecmath.sqrt: torch.sqrt of f32 is 1 ulp off on some CPUs)."""
    _, ts = both_scenes(blocker_rows())
    _, tcam = both_cams(NEE_POSE)
    kw = dict(width=32, height=16, spp=2, max_depth=3, n_active=8, nee=True)
    for render in (mk.render_megakernel_reference,
                   cluster.render_cluster_reference):
        lin = render(ts, tcam, 9, gamma=False, **kw)
        assert torch.equal(torch.clamp(vecmath.sqrt(torch.clamp_min(lin, 0.0)),
                                       0.0, 1.0), render(ts, tcam, 9, **kw))


def test_cluster_nee_needs_the_scene_or_lights():
    _, ts = both_scenes(blocker_rows())
    _, tcam = both_cams(NEE_POSE)
    tables = cluster.build_clusters(ts, n_active=8)
    kw = dict(width=16, height=8, spp=1, max_depth=2, nee=True,
              prebuilt=tables)
    with pytest.raises(ValueError, match="light_table"):
        cluster.render_cluster_reference(None, tcam, 0, **kw)
    a = cluster.render_cluster_reference(
        None, tcam, 0, lights=cluster.light_table(ts), **kw)
    assert torch.equal(a, cluster.render_cluster_reference(ts, tcam, 0, **kw))


def test_raytracer_nee_end_to_end():
    """RayTracer(seed, mode, enable_refraction, linear, nee) in the JAX
    package's positional order: its NEE batches equal the plain chain's
    with the light cdf built at set_scene; set_nee switches it."""
    rt = RayTracer(2, "v2", False, False, True, device=CPU)
    rt.set_scene(app_run.demo_api_scene())
    assert rt._lights is not None
    w, h, spp = 48, 32, 2
    acc, total = None, 0
    for _ in range(2):
        acc, total = frame.accumulate(acc, total, rt.render_device(w, h, spp,
                                                                   4), spp)
    cam = rt.camera.to_params(CPU)
    kw = dict(width=w, height=h, spp=spp, max_depth=4, n_active=12)
    acc_p, total_p = None, 0
    for f in range(2):
        b = mk.render_megakernel_reference(
            rt._scene_arrays, cam, (3 * 1000003 + f) & 0x7FFFFFFF, nee=True,
            **kw)
        acc_p, total_p = frame.accumulate(acc_p, total_p, b, spp)
    assert torch.equal(acc, acc_p) and total == total_p == 4
    rt.set_nee(False)
    plain = mk.render_megakernel_reference(
        rt._scene_arrays, cam, (3 * 1000003 + 2) & 0x7FFFFFFF, **kw)
    assert torch.equal(rt.render_device(w, h, spp, 4), plain)
    rt.set_nee(True)
    assert rt._lights is not None


def test_raytracer_nee_through_the_cluster_engine():
    """Past 64 spheres RayTracer builds the light table at set_scene; its
    batch equals the plain cluster engine's with that table."""
    rt = RayTracer(4, device=CPU)
    scene = app_run.demo_api_scene()
    src = scene.spheres[0]
    for i in range(60):  # 69 spheres: the cluster engine
        s = type(src)()
        s.center = type(src.center)(-6 + 0.2 * i, 0.1, -8.0)
        s.radius = 0.08
        s.object_id = 100 + i
        scene.add_sphere(s)
    rt.set_scene(scene)
    rt.set_nee(True)
    assert rt._lights.shape == (8 * 8 + 1,)
    img = rt.render_device(32, 16, 1, 3)
    assert rt._last_engine == "cluster"
    cam = rt.camera.to_params(CPU)  # its aspect is the render's
    ref = cluster.render_cluster_reference(
        rt._scene_arrays, cam, (5 * 1000003) & 0x7FFFFFFF, width=32,
        height=16, spp=1, max_depth=3, n_active=rt._n_active, nee=True)
    assert torch.equal(img, ref)


def test_raytracer_linear_raises():
    """RayTracer(linear=True) renders pre-gamma batches with the lax engine
    (through the LBVH, the scene's use_bvh flag), equal to the lax
    reference at the batch's seed."""
    rt = RayTracer(0, "v2", False, True, device=CPU)
    rt.set_scene(app_run.demo_api_scene())
    img = rt.render_device(32, 16, 2, 3)
    assert rt._last_engine == "lax" and rt._last_use_bvh is True
    ref = frame.render(rt._scene_arrays, rt.camera.to_params(CPU),
                       (1 * 1000003) & 0x7FFFFFFF, width=32, height=16,
                       spp=2, max_depth=3, gamma=False, engine="lax",
                       use_bvh=True)
    assert torch.equal(img, ref) and float(img.max()) > 1.0


@pytest.mark.parametrize("enhance", [True, False])
def test_display_stack_linear_matches_jax(enhance):
    a = np.random.default_rng(3).uniform(-0.1, 2.5, (16, 24, 3)).astype(
        np.float32)
    ours = display.display_stack(torch.from_numpy(a), 1.5, linear=True,
                                 enhance=enhance, as_uint8=True).numpy()
    ref = np.asarray(j_display.display_stack(jnp.asarray(a), 1.5,
                                             linear=True, enhance=enhance,
                                             as_uint8=True))
    assert ours.shape == ref.shape == (2, 16, 24, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_cuda_source_nee_constant_matches_jax():
    """The kernels cannot run here: their 1/pi is the JAX kernels'."""
    src = open(os.path.join(os.path.dirname(mk.__file__), os.pardir, "csrc",
                            "path_common.cuh")).read()
    lit = re.search(r"constexpr float kInvPi = ([0-9.]+)f;", src)[1]
    assert float(lit) == 0.3183098861837907
    assert mk._INV_PI == float(np.float32(0.3183098861837907))
