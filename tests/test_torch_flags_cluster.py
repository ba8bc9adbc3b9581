"""Refraction, thin-lens depth of field and R2 stratified sampling in the
cluster engine's plain version (K2 flags) against the JAX package.

The plain version with the flags stream for stream against
``render_cluster(..., interpret=True)`` on a 200-sphere glass field at
cluster size 8, in two configurations (one JAX compile each, shared across
seeds through a module-scoped fixture); ``render`` and ``RayTracer``
routing the flags to the cluster engine on the CPU. The CUDA kernel runs on
a GPU only (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core.scenes import random_spheres as j_random_spheres
from tpu_rt.ops import pallas_cluster as jc
from tpu_rt.ops import triangle as j_tri

from tpu_rt_torch.api import Material, RayTracer, Scene, Sphere, Vector3
from tpu_rt_torch.core.scenes import random_spheres
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.ops import triangle as tri
from tpu_rt_torch.render import frame
from tpu_rt_torch.utils.convert import camera_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
CAM_POSE = dict(position=(0, 3, 14), target=(0, 0, -6))
W, H = 100, 40
GLASS = dict(albedo=(0.9, 0.9, 0.9), metallic=0.0, roughness=0.0, ior=1.5)
QUAD = ((-2, 0.2, 2), (2, 0.2, 2), (2, 2.5, 2), (-2, 2.5, 2))


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def glass_field(scene, as_tensor):
    """Every diffuse, non-emissive sphere whose index is a multiple of 4
    (the ground, index 0, apart) made glass: roughness 0, ior 1.5."""
    idx = np.arange(scene.capacity)
    glass = ((idx % 4 == 0) & (idx > 0) & (np.asarray(scene.metallic) <= 0)
             & (np.asarray(scene.emission).max(-1) <= 0))
    rough = np.where(glass, 0.0, np.asarray(scene.roughness))
    ior = np.where(glass, 1.5, np.asarray(scene.ior))
    return scene._replace(roughness=as_tensor(rough.astype(np.float32)),
                          ior=as_tensor(ior.astype(np.float32)))


@pytest.fixture(scope="module")
def field200():
    """random_spheres(200, seed=3) as a glass field, in both packages."""
    return (glass_field(j_random_spheres(200, seed=3), jnp.asarray),
            glass_field(random_spheres(200, seed=3, device=CPU),
                        torch.from_numpy))


CONFIGS = {
    # (a) refraction + thin lens, with a glass quad in front of the field
    "refract_dof_quad": dict(enable_refraction=True, enable_dof=True),
    # (b) stratify + refraction, pinhole
    "stratify_refract": dict(enable_refraction=True, stratify=True),
}


@pytest.fixture(scope="module")
def k2_flags(field200):
    """Both packages' (image, segments) for a config and seed: one JAX
    interpret-mode compile per config serves both seeds."""
    js, ts = field200
    out = {}

    def render(name, seed):
        if (name, seed) not in out:
            flags = CONFIGS[name]
            jcam = tpu_rt.make_camera(
                aspect=W / H, aperture=0.1 if flags.get("enable_dof") else 0.0,
                **CAM_POSE)
            tcam = camera_from_numpy(to_np_fields(jcam), CPU)
            kw = dict(width=W, height=H, spp=2, max_depth=4, n_active=200,
                      cluster_size=8, with_stats=True, **flags)
            jm = tm = None
            if name == "refract_dof_quad":
                jm = j_tri.quad(*QUAD, **GLASS)
                tm = tri.quad(*QUAD, device=CPU, **GLASS)
            ref, ref_segs = jc.render_cluster(js, jcam, seed, interpret=True,
                                              mesh=jm, **kw)
            ours, segs = cluster.render_cluster_reference(ts, tcam, seed,
                                                          mesh=tm, **kw)
            out[name, seed] = (np.asarray(ref), int(ref_segs), ours.numpy(),
                               int(segs))
        return out[name, seed]
    return render


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_matches_render_cluster_with_flags(k2_flags, name, seed):
    """100x40 with jitter, 2 spp, depth 4, 37 glass spheres: the tolerances
    of the flag-free streams (branch flips from transcendental ulps between
    XLA:CPU and torch)."""
    ref, ref_segs, ours, segs = k2_flags(name, seed)
    assert ours.shape == (H, W, 3)
    d = np.abs(ours - ref)
    assert float((d <= 1e-4).mean()) >= 0.999
    assert abs(segs - ref_segs) <= 1e-3 * ref_segs


def test_render_routes_flags_to_the_cluster_engine(field200):
    _, ts = field200
    cam = tpu_rt.make_camera(aspect=2.0, aperture=0.2, **CAM_POSE)
    tcam = camera_from_numpy(to_np_fields(cam), CPU)
    kw = dict(width=32, height=16, spp=1, max_depth=3)
    flags = dict(enable_refraction=True, stratify=True)
    assert frame.select_engine(ts, enable_refraction=True) == "cluster"
    # enable_dof=None: the camera's aperture switches the lens on
    a = frame.render(ts, tcam, 5, **kw, **flags)
    b = cluster.render_cluster_reference(
        ts, tcam, 5, n_active=frame.quantize_count(200, ts.capacity),
        enable_dof=True, **kw, **flags)
    assert torch.equal(a, b)
    # with NEE too (tests/test_torch_nee.py holds NEE against the JAX
    # package)
    a = frame.render(ts, tcam, 5, nee=True, **kw, **flags)
    b = cluster.render_cluster_reference(
        ts, tcam, 5, n_active=frame.quantize_count(200, ts.capacity),
        enable_dof=True, nee=True, **kw, **flags)
    assert torch.equal(a, b)


def glass_api_scene(n):
    rng = np.random.default_rng(71)
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
        m.roughness = 0.0 if i % 3 == 1 else 0.4
        m.emission = Vector3(4, 4, 3) if i % 9 == 2 else Vector3()
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


def test_raytracer_flags_on_the_cluster_engine():
    """RayTracer(enable_refraction=True) with a lens and set_stratify past
    64 spheres: the cluster engine, to batches equal to the plain chain's."""
    rt = RayTracer(seed=6, enable_refraction=True, device=CPU)
    rt.set_scene(glass_api_scene(70))
    cam = rt.get_camera()
    cam.aperture, cam.focus_dist = 0.15, 0.0
    rt.set_camera(cam)
    rt.set_stratify(True)
    w, h, spp = 48, 32, 2
    acc, total = None, 0
    for _ in range(2):
        batch = rt.render_device(w, h, spp, 3)
        acc, total = frame.accumulate(acc, total, batch, spp)
    assert rt._last_engine == "cluster"

    tables = cluster.build_clusters(rt._scene_arrays,
                                    n_active=frame.quantize_count(70, 128))
    acc_p, total_p = None, 0
    for f in range(2):
        b = cluster.render_cluster_reference(
            None, rt.camera.to_params(CPU), (7 * 1000003 + f) & 0x7FFFFFFF,
            width=w, height=h, spp=spp, max_depth=3, prebuilt=tables,
            enable_refraction=True, enable_dof=True, stratify=True)
        acc_p, total_p = frame.accumulate(acc_p, total_p, b, spp)
    assert torch.equal(acc, acc_p) and total == total_p == 4
