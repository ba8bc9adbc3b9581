"""Refraction, thin-lens depth of field and R2 stratified sampling in the
megakernel's plain version (K1 flags) against the JAX package.

``generate_rays(lens_xi=)`` against ``tpu_rt.core.camera``; the plain
version with the flags stream for stream against ``render_pallas(...,
interpret=True)`` in two configurations (one JAX compile each, shared
across seeds through a module-scoped fixture); ``RayTracer`` with the flags
end to end on the CPU; the headless app's ``--aperture``; and
``enhance_contrast`` at sizes ``torch.quantile`` refuses. The CUDA kernel
runs on a GPU only (tests/test_torch_gpu.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core import camera as j_camera
from tpu_rt.ops import pallas_megakernel as j_mk
from tpu_rt.ops import triangle as j_tri
from tpu_rt.render import frame as j_frame

import tpu_rt_torch
from tpu_rt_torch.api import RayTracer
from tpu_rt_torch.app import run as app_run
from tpu_rt_torch.core import camera
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.ops import triangle as tri
from tpu_rt_torch.render import frame
from tpu_rt_torch.utils.convert import camera_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
W, H = 100, 40
# a glass box in front of the demo scene's spheres
GLASS = dict(albedo=(0.95, 0.95, 0.95), metallic=0.0, roughness=0.0, ior=1.5)
BOX = dict(center=(0.0, 0.4, 0.5), size=(1.0, 0.8, 0.6))


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.mark.parametrize("focus_dist", [0.0, 3.0], ids=["look_at", "focus_3"])
def test_generate_rays_lens_matches_jax(focus_dist):
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 1, (6, 7)).astype(np.float32)
    v = rng.uniform(0, 1, (6, 7)).astype(np.float32)
    xi = rng.uniform(0, 1, (6, 7, 2)).astype(np.float32)
    jc = tpu_rt.make_camera(position=(0.5, 2, 5), target=(0, 0, -1),
                            aspect=1.5, aperture=0.2, focus_dist=focus_dist)
    tc = camera_from_numpy(to_np_fields(jc), CPU)
    o, d = camera.generate_rays(tc, torch.from_numpy(u), torch.from_numpy(v),
                                lens_xi=torch.from_numpy(xi))
    jo, jd = j_camera.generate_rays(jc, jnp.asarray(u), jnp.asarray(v),
                                    lens_xi=jnp.asarray(xi))
    assert o.shape == d.shape == (6, 7, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    # the lens moves the origins off the pinhole
    assert float((o - tc.position).abs().max()) > 1e-3


CONFIGS = {
    # (a) refraction + thin lens, with a glass box beside the spheres
    "refract_dof_box": dict(enable_refraction=True, enable_dof=True),
    # (b) stratify + refraction, pinhole
    "stratify_refract": dict(enable_refraction=True, stratify=True),
}


@pytest.fixture(scope="module")
def k1_flags():
    """Both packages' (image, segments) for a config and seed: the seed is
    traced, so one JAX interpret-mode compile serves both seeds."""
    js = tpu_rt.demo_scene()
    ts = tpu_rt_torch.demo_scene(device=CPU)
    out = {}

    def render(name, seed):
        if (name, seed) not in out:
            flags = CONFIGS[name]
            jc = tpu_rt.make_camera(
                aspect=W / H, aperture=0.1 if flags.get("enable_dof") else 0.0)
            tc = camera_from_numpy(to_np_fields(jc), CPU)
            kw = dict(width=W, height=H, spp=2, max_depth=4, n_active=12,
                      with_stats=True, **flags)
            jm = tm = None
            if name == "refract_dof_box":
                jm = j_tri.box(**BOX, **GLASS)
                tm = tri.box(**BOX, device=CPU, **GLASS)
                kw["n_tri_active"] = 12
            ref, ref_segs = j_mk.render_pallas(js, jc, seed, interpret=True,
                                               mesh=jm, **kw)
            ours, segs = mk.render_megakernel_reference(ts, tc, seed,
                                                        mesh=tm, **kw)
            out[name, seed] = (np.asarray(ref), int(ref_segs), ours.numpy(),
                               int(segs))
        return out[name, seed]
    return render


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_matches_render_pallas_with_flags(k1_flags, name, seed):
    """100x40 with jitter, 2 spp, depth 4: the same tolerances as the
    flag-free streams (branch flips from transcendental ulps between
    XLA:CPU and torch)."""
    ref, ref_segs, ours, segs = k1_flags(name, seed)
    assert ours.shape == (H, W, 3)
    d = np.abs(ours - ref)
    assert float((d <= 1e-4).mean()) >= 0.999
    assert abs(segs - ref_segs) <= 1e-3 * ref_segs


def api_camera(rt, aperture):
    cam = rt.get_camera()
    cam.aperture = aperture
    cam.focus_dist = 4.0
    rt.set_camera(cam)


def test_raytracer_with_all_flags_end_to_end():
    """RayTracer(enable_refraction=True) with a lens and set_stratify: its
    batches equal the plain chain's, the flags change the image, and the
    positional order is the JAX package's."""
    rt = RayTracer(3, "v2", True, device=CPU)
    rt.set_scene(app_run.demo_api_scene())
    api_camera(rt, 0.1)
    rt.set_stratify(True)
    w, h, spp = 48, 32, 2
    before = mk.render_megakernel.launches
    acc, total = None, 0
    for _ in range(2):
        batch = rt.render_device(w, h, spp, 4)
        acc, total = frame.accumulate(acc, total, batch, spp)
    assert rt._last_engine == "pallas"
    assert mk.render_megakernel.launches == before  # CPU: the plain version

    cam = rt.camera.to_params(CPU)
    kw = dict(width=w, height=h, spp=spp, max_depth=4, n_active=12)
    flags = dict(enable_refraction=True, enable_dof=True, stratify=True)
    acc_p, total_p = None, 0
    for f in range(2):
        b = mk.render_megakernel_reference(
            rt._scene_arrays, cam, (4 * 1000003 + f) & 0x7FFFFFFF, **kw,
            **flags)
        acc_p, total_p = frame.accumulate(acc_p, total_p, b, spp)
    assert torch.equal(acc, acc_p) and total == total_p == 4
    # each flag changes the frame
    seed = (4 * 1000003) & 0x7FFFFFFF
    first = mk.render_megakernel_reference(rt._scene_arrays, cam, seed, **kw,
                                           **flags)
    for off in flags:
        other = mk.render_megakernel_reference(
            rt._scene_arrays, cam, seed, **kw,
            **{k: v and k != off for k, v in flags.items()})
        assert not torch.equal(first, other), off


def test_stratify_without_jitter_shoots_pixel_centres():
    """As in the JAX kernels, the R2 lattice replaces jitter only: without
    jitter both the megakernel and the cluster engine shoot pixel
    centres."""
    scene = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    kw = dict(width=32, height=16, spp=2, max_depth=3, jitter=False,
              n_active=12)
    for render in (mk.render_megakernel_reference,
                   cluster.render_cluster_reference):
        assert torch.equal(render(scene, cam, 3, stratify=True, **kw),
                           render(scene, cam, 3, **kw))


def test_raytracer_mode_v1_raises():
    """RayTracer(mode="v1") renders with the lax engine (through the LBVH,
    the scene's use_bvh flag), refraction on, equal to the lax reference at
    the batch's seed."""
    rt = RayTracer(0, "v1", True, device=CPU)
    rt.set_scene(app_run.demo_api_scene())
    img = rt.render_device(32, 16, 2, 3)
    assert rt._last_engine == "lax" and rt._last_use_bvh is True
    ref = frame.render(rt._scene_arrays, rt.camera.to_params(CPU),
                       (1 * 1000003) & 0x7FFFFFFF, width=32, height=16,
                       spp=2, max_depth=3, mode="v1", enable_refraction=True,
                       engine="lax", use_bvh=True)
    assert torch.equal(img, ref) and 0.0 <= float(img.min())
    assert float(img.max()) <= 1.0


def test_headless_app_with_aperture(tmp_path):
    out = tmp_path / "x.png"
    rc = app_run.main(["--headless", "--device", "cpu", "--width", "32",
                       "--height", "24", "--samples", "2", "--batch", "2",
                       "--depth", "2", "--aperture", "0.1", "--focus-dist",
                       "3", "--output", str(out)])
    assert rc == 0
    assert out.exists() or (tmp_path / "x.png.npy").exists()


@pytest.mark.parametrize("seed", [0, 5])
def test_enhance_contrast_matches_jax(seed):
    a = np.random.default_rng(seed).uniform(0, 1.2, (30, 41, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        frame.enhance_contrast(torch.from_numpy(a)).numpy(),
        np.asarray(j_frame.enhance_contrast(jnp.asarray(a))), rtol=0,
        atol=1e-6)


def test_enhance_contrast_past_2_to_the_24_values():
    """torch.quantile refuses more than 2^24 values; the stretch takes any
    size and equals numpy's linear percentiles in float64 to 1e-5."""
    a = np.random.default_rng(2).uniform(0, 1, (1366, 4097, 3)).astype(
        np.float32)
    assert a.size > 2**24
    lo, hi = np.percentile(a.astype(np.float64), [2.0, 98.0])
    ours = frame.enhance_contrast(torch.from_numpy(a)).numpy()
    row = a[683].astype(np.float64)
    want = np.clip((row - lo) / (hi - lo), 0.0, 1.0)
    np.testing.assert_allclose(ours[683], want, rtol=0, atol=1e-5)


def test_cuda_source_r2_constants_match_jax():
    """The kernels cannot run here: their R2 steps are the JAX package's."""
    src = open(os.path.join(os.path.dirname(mk.__file__), os.pardir, "csrc",
                            "path_common.cuh")).read()
    for name, ref in (("kR2AlphaU", j_mk.R2_ALPHA_U),
                      ("kR2AlphaV", j_mk.R2_ALPHA_V)):
        lit = re.search(rf"constexpr float {name} = ([0-9.]+)f;", src)[1]
        assert float(lit) == ref
    assert (mk.R2_ALPHA_U, mk.R2_ALPHA_V) == (j_mk.R2_ALPHA_U, j_mk.R2_ALPHA_V)
