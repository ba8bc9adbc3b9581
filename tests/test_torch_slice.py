"""The port's main path as a whole, against the same chain composed by hand
in the JAX package: RayTracer.render_device -> accumulate -> display_stack.

The JAX RayTracer resolves to its lax engine on the CPU, so the JAX side
calls ``render_pallas(interpret=True)`` directly with the RayTracer's seeds
(tpu_rt/api/compat.py:480); the port's RayTracer runs the megakernel's plain
version because its scene lies on the CPU.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.ops.pallas_megakernel import render_pallas
from tpu_rt.render import display as j_display
from tpu_rt.render import frame as j_frame

import tpu_rt_torch
from tpu_rt_torch.api import Camera, RayTracer, Scene, Vector3
from tpu_rt_torch.app import run as app_run
from tpu_rt_torch.core import camera, rng, vecmath
from tpu_rt_torch.ops import integrator
from tpu_rt_torch.ops.megakernel import render_megakernel
from tpu_rt_torch.ops.triangle import quad
from tpu_rt_torch.render import display, frame

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
W, H, SPP, DEPTH, BATCHES = 128, 64, 2, 4, 3


def test_main_path_matches_jax_chain():
    rt = RayTracer(device=CPU)
    rt.set_scene(app_run.demo_api_scene())
    before = render_megakernel.launches
    acc, total = None, 0
    for _ in range(BATCHES):
        batch = rt.render_device(W, H, SPP, DEPTH)
        acc, total = frame.accumulate(acc, total, batch, SPP)
    stack = display.display_stack(acc, app_run.EXPOSURE, as_uint8=True)
    assert render_megakernel.launches == before  # CPU: the plain version
    assert rt._last_engine == "pallas"
    assert total == BATCHES * SPP
    assert stack.shape == (2, H, W, 3) and stack.dtype == torch.uint8

    js = tpu_rt.demo_scene()
    jc = tpu_rt.make_camera(aspect=W / H)
    j_acc, j_total = None, 0
    for f in range(BATCHES):
        seed = (1 * 1000003 + f) & 0x7FFFFFFF  # RayTracer(seed=0), frame f
        img = render_pallas(js, jc, seed, width=W, height=H, spp=SPP,
                            max_depth=DEPTH, interpret=True, n_active=12)
        j_acc, j_total = j_frame.accumulate(j_acc, j_total, img, SPP)
    j_stack = np.asarray(j_display.display_stack(j_acc, 1.5, as_uint8=True))

    lsb = np.abs(stack.numpy().astype(int) - j_stack.astype(int))
    assert float((lsb <= 1).mean()) >= 0.99
    d = np.abs(acc.numpy() - np.asarray(j_acc))
    assert float(d.mean()) <= 1e-4


@pytest.mark.parametrize("seed", [0, 3])
def test_tone_map_enhance_accumulate_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1.2, (20, 30, 3)).astype(np.float32)
    b = rng.uniform(0, 1.2, (20, 30, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(frame.tone_map(ta, 1.5).numpy(),
                               np.asarray(j_frame.tone_map(jnp.asarray(a),
                                                           1.5)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(frame.enhance_contrast(ta).numpy(),
                               np.asarray(j_frame.enhance_contrast(
                                   jnp.asarray(a))), rtol=0, atol=1e-5)
    acc, n = frame.accumulate(ta, 8, tb, 4)
    j_acc, j_n = j_frame.accumulate(jnp.asarray(a), 8, jnp.asarray(b), 4)
    assert n == j_n == 12
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), rtol=0,
                               atol=1e-6)
    first, n0 = frame.accumulate(None, 0, tb, 4)
    assert first is tb and n0 == 4


def test_enhance_contrast_flat_image_passes_through():
    img = torch.full((4, 5, 3), 0.25)
    assert torch.equal(frame.enhance_contrast(img), img)


@pytest.mark.parametrize("enhance", [True, False])
def test_display_stack_matches_jax(enhance):
    a = np.random.default_rng(1).uniform(0, 1.5, (16, 24, 3)).astype(
        np.float32)
    ours = display.display_stack(torch.from_numpy(a), 1.5, enhance=enhance,
                                 as_uint8=True).numpy()
    ref = np.asarray(j_display.display_stack(jnp.asarray(a), 1.5,
                                             enhance=enhance, as_uint8=True))
    assert ours.shape == ref.shape == (2, 16, 24, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_display_stack_denoisers_not_ported():
    """The denoisers are ported: a bilateral row on a 4x4 image (its
    9-wide window reflects past the edge) equals the JAX package's."""
    a = np.random.default_rng(2).uniform(0, 1.5, (4, 4, 3)).astype(np.float32)
    ours = display.display_stack(torch.from_numpy(a), 1.5,
                                 methods=("bilateral",)).numpy()
    ref = np.asarray(j_display.display_stack(jnp.asarray(a), 1.5,
                                             methods=("bilateral",)))
    assert ours.shape == ref.shape == (3, 4, 4, 3)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-5)


MASK = torch.ones(1, dtype=torch.int32)
UNSUPPORTED = {
    # the v1 estimator and linear output with engine="auto" are the lax
    # engine's, as in the JAX package
    "mode_v1": dict(mode="v1"),
    "linear": dict(gamma=False),
    # a mesh, refraction, DOF, stratify and NEE render
    # (tests/test_torch_triangle.py, test_torch_flags_mega.py,
    # test_torch_nee.py), and so do they under a tile mask: an all-ones
    # mask renders what no mask does
    "mesh": dict(mesh=quad((-1, 0, -2), (1, 0, -2), (1, 1, -2), (-1, 1, -2),
                           device=CPU), tile_mask=MASK),
    "refraction": dict(enable_refraction=True, tile_mask=MASK),
    "nee": dict(nee=True, tile_mask=MASK),
    "stratify": dict(stratify=True, tile_mask=MASK),
    "tile_mask": dict(tile_mask=MASK),
    "dof_flag": dict(enable_dof=True, tile_mask=MASK),
    "aperture": dict(nee=True, tile_mask=MASK),
    "engine_lax": dict(engine="lax"),
    # the cluster engine, asked for or past 64 spheres, renders (see
    # tests/test_torch_cluster.py), under a mask of its screen blocks too
    "engine_cluster": dict(engine="cluster", nee=True, tile_mask=MASK),
    "over_64_spheres": dict(gamma=False),
}


LAX_CASES = ("mode_v1", "linear", "engine_lax", "over_64_spheres")


def lax_reference(scene, cam, seed, width, height, spp, max_depth,
                  mode="v2", gamma=True, **_):
    """The lax engine's batch composed by hand from the port's threefry
    streams, camera and integrator: sample s from fold_in(key(seed), s),
    split into its jitter and trace keys."""
    key = rng.key(seed, device=CPU)
    acc = torch.zeros((height * width, 3))
    for s in range(spp):
        k_jit, k_trace = rng.split(rng.fold_in(key, s), 2)
        u, v = camera.pixel_uv(width, height,
                               rng.uniform(k_jit, (height, width, 2)),
                               device=CPU)
        o, d = camera.generate_rays(cam, u.reshape(-1), v.reshape(-1))
        acc = acc + integrator.trace(scene, o, d, k_trace,
                                     max_depth=max_depth, mode=mode)
    img = acc.reshape(height, width, 3) / spp
    if gamma:
        img = torch.clamp(vecmath.sqrt(torch.clamp_min(img, 0.0)), 0.0, 1.0)
    return img


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_render_raises_for_configurations_not_ported(name):
    """The configurations the port did not carry raised, naming their
    ROADMAP.md item. The tile-mask cases raised until the mask was ported;
    now each renders, and with an all-ones mask equals the unmasked
    render. The lax cases (v1, linear output under engine="auto", the lax
    engine named, linear output past 64 spheres) raised until the lax
    engine was ported; now each renders and equals the lax reference at its
    size."""
    kw = UNSUPPORTED[name]
    n = 65 if name == "over_64_spheres" else 9
    scene = tpu_rt_torch.make_scene(
        np.zeros((n, 3)), np.ones(n), np.ones((n, 3)), np.zeros(n),
        np.zeros(n), np.zeros((n, 3)), device=CPU)
    cam = tpu_rt_torch.make_camera(
        aperture=0.1 if name == "aperture" else 0.0, device=CPU)
    args = dict(width=16, height=8, spp=1, max_depth=1)
    if "tile_mask" in kw:
        unmasked = {k: v for k, v in kw.items() if k != "tile_mask"}
        a, sa = frame.render(scene, cam, 0, with_stats=True, **args, **kw)
        b, sb = frame.render(scene, cam, 0, with_stats=True, **args,
                             **unmasked)
        assert torch.equal(a, b) and int(sa) == int(sb) > 0
        return
    assert name in LAX_CASES
    assert frame.select_engine(scene, **{k: v for k, v in kw.items()}) \
        == "lax"
    img = frame.render(scene, cam, 0, **args, **kw)
    assert img.shape == (8, 16, 3) and torch.isfinite(img).all()
    assert torch.equal(img, lax_reference(scene, cam, 0, **args, **kw))


def test_select_engine():
    scene = tpu_rt_torch.demo_scene(device=CPU)
    assert frame.select_engine(scene) == "pallas"
    assert frame.select_engine(scene, engine="pallas") == "pallas"
    for name in ("warp", "megakernel"):  # names the JAX package lacks
        with pytest.raises(ValueError):
            frame.select_engine(scene, engine=name)


@pytest.mark.parametrize("n, cap", [(0, 16), (9, 16), (16, 16), (70, 128),
                                    (300, 1024), (300, 256)])
def test_quantize_count_matches_jax(n, cap):
    assert frame.quantize_count(n, cap) == j_frame.quantize_count(n, cap)


def test_render_derives_n_active():
    scene = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    a = frame.render(scene, cam, 5, width=32, height=16, spp=1, max_depth=2)
    b = frame.render(scene, cam, 5, width=32, height=16, spp=1, max_depth=2,
                     n_active=12)
    assert torch.equal(a, b)


def test_raytracer_surface():
    rt = RayTracer(seed=3, device=CPU)
    assert rt.render_device(8, 4, 1, 1) is None  # no scene yet
    assert np.array_equal(rt.render(8, 4, 1, 1), np.zeros(8 * 4 * 3))
    scene = app_run.demo_api_scene()
    rt.set_scene(scene)
    scene.spheres.clear()  # the snapshot does not see later edits
    flat = rt.render(16, 8, 1, 2)
    assert flat.shape == (16 * 8 * 3,) and flat.max() > 0
    cam = rt.get_camera()
    cam.position.x += 1.0
    assert rt.camera.position.x == 0.0  # get_camera returns a copy
    rt.move_camera(Vector3(0.0, 0.5, 0.0))
    assert rt.camera.position.y == 2.5
    c = Camera()
    rt.set_camera(c)
    assert rt.camera is c
    empty = Scene()
    rt.set_scene(empty)
    assert rt.render_device(8, 4, 1, 1) is None


def test_headless_app_writes_image(tmp_path, monkeypatch):
    out = tmp_path / "x.png"
    rc = app_run.main(["--headless", "--device", "cpu", "--width", "48",
                       "--height", "32", "--samples", "3", "--batch", "2",
                       "--depth", "2", "--output", str(out)])
    assert rc == 0
    written = out if out.exists() else tmp_path / "x.png.npy"
    assert written.exists()
    # without PyQt5 the GUI mode returns 1, as the JAX package's launcher
    monkeypatch.setitem(sys.modules, "PyQt5", None)
    monkeypatch.delitem(sys.modules, "tpu_rt_torch.app.gui", raising=False)
    assert app_run.main(["--device", "cpu"]) == 1
