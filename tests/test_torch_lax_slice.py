"""The lax slice as a whole on the CPU: the port's RayTracer(linear=True)
and RayTracer(mode="v1"), trace_ray and a RayTracerInteraction session
with linear accumulation, against the JAX package's (whose RayTracer
resolves to its lax engine on the CPU, and honours the scene's use_bvh
flag: both go through the LBVH), at the same seeds; select_engine against
the JAX package's TPU rule over the whole (mode, gamma, capacity, mesh,
engine) matrix; the depth-1 C++ golden through the lax engine.

Values: at least 99.9% within 1e-4 (XLA:CPU's arithmetic is the known gap,
tests/test_torch_integrator.py); three JAX compilations (the two jitted
RayTracer batches, which the JAX session reuses, and trace_ray's trace)."""

import itertools
import os
import time

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt.api
import tpu_rt.app
import tpu_rt.app.interaction
from tpu_rt.core import types as j_types
from tpu_rt.ops import triangle as j_triangle
from tpu_rt.render import frame as j_frame

import tpu_rt_torch
from tpu_rt_torch.api import Ray, RayTracer, Vector3
from tpu_rt_torch.app import RayTracerInteraction, SceneManager
from tpu_rt_torch.ops import triangle
from tpu_rt_torch.ops.megakernel import render_megakernel
from tpu_rt_torch.render import frame

# six xdist workers share the CPU: one intra-op thread each
torch.set_num_threads(1)
CPU = torch.device("cpu")
W, H, SPP, DEPTH, BATCHES = 32, 24, 2, 4, 2
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _close(ours: np.ndarray, ref: np.ndarray):
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    frac = (np.abs(ours - ref) <= 1e-4).mean()
    assert frac >= 0.999, frac


def _batches(rt, n=BATCHES):
    return [np.asarray(rt.render_device(W, H, SPP, DEPTH)) for _ in range(n)]


@pytest.mark.parametrize("kw", [dict(linear=True), dict(mode="v1")],
                         ids=["linear", "v1"])
def test_raytracer_lax_batches_match_jax(kw):
    ours = RayTracer(device=CPU, **kw)
    ours.set_scene(SceneManager.create_interactive_scene())
    ref = tpu_rt.api.RayTracer(**kw)
    ref.set_scene(tpu_rt.app.SceneManager.create_interactive_scene())
    before = render_megakernel.launches
    a, b = _batches(ours), _batches(ref)
    assert render_megakernel.launches == before
    assert ours._last_engine == ref._last_engine == "lax"
    assert ours._last_use_bvh is ref._last_use_bvh is True
    for x, y in zip(a, b):
        assert x.shape == (H, W, 3)
        _close(x, y)
    if kw.get("linear"):
        assert max(x.max() for x in a) > 1.0  # pre-gamma radiance
    else:
        assert max(x.max() for x in a) <= 1.0
    assert not np.array_equal(a[0], a[1])  # batches draw fresh samples


def test_trace_ray_matches_jax():
    ours = RayTracer(seed=3, device=CPU)
    ours.set_scene(SceneManager.create_interactive_scene())
    ref = tpu_rt.api.RayTracer(seed=3)
    ref.set_scene(tpu_rt.app.SceneManager.create_interactive_scene())
    targets = [(0, 0.5, -3), (2, 0.5, -3), (0, 3, -1), (0, 1, 0), (5, 9, 1)]
    got = []
    for tx, ty, tz in targets:
        o = (0.0, 2.0, 5.0)
        d = (tx - o[0], ty - o[1], tz - o[2])
        a = ours.trace_ray(Ray(Vector3(*o), Vector3(*d)), 0, 4)
        b = ref.trace_ray(tpu_rt.api.compat.Ray(tpu_rt.api.Vector3(*o),
                                                tpu_rt.api.Vector3(*d)),
                          0, 4)
        got.append((a.x, a.y, a.z))
        np.testing.assert_allclose([a.x, a.y, a.z], [b.x, b.y, b.z],
                                   rtol=1e-4, atol=1e-5)
    assert ours._frame == ref._frame == len(targets)
    assert any(max(g) > 1.0 for g in got)  # a light
    assert RayTracer(device=CPU).trace_ray(
        Ray(Vector3(0, 0, 0), Vector3(0, 0, -1)), 0, 4).to_array().tolist() \
        == [0.0, 0.0, 0.0]  # no scene


def _session(pkg, **kw):
    r = (RayTracerInteraction(W, H, linear_accumulation=True, device="cpu")
         if pkg == "torch" else
         tpu_rt.app.interaction.RayTracerInteraction(
             W, H, linear_accumulation=True))
    r.settings.update(max_samples=SPP * BATCHES, samples_per_batch=SPP,
                      max_depth=DEPTH)
    frames = []
    try:
        r.start_rendering()
        t0 = time.time()
        while time.time() - t0 < 120:
            f = r.get_frame()
            if f is None:
                time.sleep(0.02)
                continue
            frames.append(f)
            if f.get("done"):
                break
    finally:
        r.stop_rendering()
    assert frames and frames[-1].get("done"), "the session did not finish"
    return r, frames


def test_linear_accumulation_session_matches_jax():
    ours, f_ours = _session("torch")
    ref, f_ref = _session("jax")
    assert ours.ray_tracer._last_engine == "lax"
    assert ours.total_samples == ref.total_samples == SPP * BATCHES
    _close(ours.accumulated_image, ref.accumulated_image)
    assert ours.accumulated_image.max() > 1.0  # linear, pre-gamma
    a, b = ([f for f in fs if "display" in f][-1] for fs in (f_ours, f_ref))
    assert a["samples"] == b["samples"] == SPP * BATCHES
    a, b = (np.asarray(f["display"]).astype(int) for f in (a, b))
    assert a.shape == b.shape and (np.abs(a - b) <= 1).mean() >= 0.999


def _scenes(n):
    """(JAX scene, port scene) of n spheres (only the bucket matters)."""
    args = (np.zeros((n, 3)), np.ones(n), np.ones((n, 3)), np.zeros(n),
            np.zeros(n), np.zeros((n, 3)))
    return (j_types.make_scene(*args),
            tpu_rt_torch.make_scene(*args, device=CPU))


def _meshes(n):
    if n is None:
        return None, None
    verts = np.zeros((3, 3), np.float32)
    return (j_triangle.make_mesh(verts, [[0, 1, 2]], capacity=n),
            triangle.make_mesh(verts, [[0, 1, 2]], capacity=n, device=CPU))


def test_select_engine_matches_the_jax_tpu_rule(monkeypatch):
    monkeypatch.setattr(j_frame, "_on_tpu", lambda scene: True)
    scenes = {n: _scenes(n) for n in (9, 64, 65)}
    meshes = {n: _meshes(n) for n in (None, 256, 512)}
    seen = set()
    for mode, gamma, n, m, engine, refr in itertools.product(
            ("v1", "v2"), (True, False), scenes, meshes,
            ("auto", "pallas", "lax", "cluster"), (False, True)):
        (js, ts), (jm, tm) = scenes[n], meshes[m]
        ref = j_frame.select_engine(js, mode, refr, gamma, jm, engine)
        assert frame.select_engine(ts, mode, refr, gamma, tm, engine) == ref
        seen.add(ref)
    assert seen == {"pallas", "cluster", "lax"}
    with pytest.raises(ValueError):
        frame.select_engine(scenes[9][1], engine="megakernel")


def test_lax_engine_depth1_golden_and_tile_mask():
    gold = np.load(os.path.join(GOLDENS, "ref_depth1_160x120.npy"))
    scene = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=160 / 120, device=CPU)
    kw = dict(width=160, height=120, spp=1, max_depth=1, jitter=False)
    img = frame.render(scene, cam, 0, engine="lax", **kw)
    assert img.shape == (120, 160, 3) and img.dtype == torch.float32
    assert np.abs(img.numpy() - gold).max() <= 1e-6
    # v1 resolves to the lax engine; at depth 1 it is the same image
    assert torch.equal(frame.render(scene, cam, 0, mode="v1", **kw), img)
    with pytest.raises(ValueError, match="tile_mask"):
        frame.render(scene, cam, 0, engine="lax",
                     tile_mask=torch.ones(5, dtype=torch.int32), **kw)
