"""tpu_rt_torch on an NVIDIA GPU: the CUDA megakernel and cluster kernel
against their plain PyTorch versions, with and without triangle meshes and
with refraction, thin-lens DOF, R2 stratification, next-event estimation,
linear output, adaptive tile masks and bands of rows, their RMSE of means
against the JAX package's N=4096 goldens, and the display at 4K UHD; the
FMA microkernel (K3) against its plain version and the measured f32 rate
against the theoretical; the denoiser bank and the first-hit AOVs on the
card against the CPU; the megakernel's per-sample threads at spp that do
and do not divide a warp, and its counting instantiation against the plain
version's counts; the cluster kernel's warp walk of the triangle table on
the terrain in every triangle instantiation, from above and half sky, and
its refusal of triangle rows off a 16-byte boundary; the interactive
runtime's session on the card against its hand-driven chain, and the Qt
GUI (against tests/pyqt5_stub/) receiving a real 640x480 frame from the
card; the lax engine's threefry bits, LBVH
hits and renders on the card against the CPU's; render_sharded over a mesh
of cuda:0 entries against its kernels' and plain versions' bands, and its
lax engine against the CPU's; the port's spans, upload counter and
launch counter under a profiler; a RayTracer's kernel inputs, built once
per scene and pose, against the per-call path, and its batches enqueued
without waiting for the card.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False. Imports no jax, so it runs on a machine with torch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.core.scenes import cornell_box, random_spheres, terrain_mesh
from tpu_rt_torch.ops.cluster import (
    build_clusters, build_tri_clusters, order_clusters, render_cluster,
    render_cluster_reference)
from tpu_rt_torch.ops.megakernel import (
    megakernel_visits_reference, render_megakernel,
    render_megakernel_reference)
from tpu_rt_torch.ops.triangle import box, merge_meshes
from tpu_rt_torch.app.denoiser import Denoiser
from tpu_rt_torch.render.aov import render_aovs
from tpu_rt_torch.render.display import display_stack, unpack_grid
from tpu_rt_torch.render.frame import cluster_tile_map
from tpu_rt_torch.utils import roofline as rl

pytestmark = pytest.mark.cuda

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
N_ACTIVE = 12  # quantize_count(9, 16)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scene(dev):
    return tpu_rt_torch.demo_scene(device=dev)


@pytest.mark.parametrize("shape", [(640, 480, 8, 4), (1920, 1080, 4, 4)],
                         ids=["640x480_8spp", "1080p_4spp"])
def test_kernel_matches_plain_at_main_path_shapes(dev, scene, shape):
    w, h, spp, depth = shape
    cam = tpu_rt_torch.make_camera(aspect=w / h, device=dev)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth,
              n_active=N_ACTIVE, with_stats=True)
    before = render_megakernel.launches
    a, seg_a = render_megakernel(scene, cam, 2**31 - 2, **kw)
    b, seg_b = render_megakernel_reference(scene, cam, 2**31 - 2, **kw)
    torch.cuda.synchronize(dev)
    assert render_megakernel.launches == before + 1
    assert a.shape == (h, w, 3) and a.device == dev
    # no FMA contraction (--fmad=false): bit for bit, segments included
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


@pytest.mark.parametrize("n, jitter", [(64, True), (64, False), (23, True)],
                         ids=["64_spheres", "64_spheres_centres", "23_spheres"])
def test_kernel_matches_plain_on_random_scenes(dev, n, jitter):
    """A full 64-row table (staged into shared memory in several passes),
    metals, lights and padding rows, at a ragged 200x90 frame."""
    rng = np.random.default_rng(n)
    scene = tpu_rt_torch.make_scene(
        centers=rng.uniform(-3, 3, (n, 3)) + [0, 0, -4],
        radii=rng.uniform(0.2, 1.0, n), albedos=rng.uniform(0, 1, (n, 3)),
        metallics=rng.uniform(-0.5, 1, n), roughnesses=rng.uniform(0, 1, n),
        emissions=rng.uniform(0, 3, (n, 3)) * (rng.uniform(0, 1, (n, 1)) < 0.2),
        capacity=64, device=dev)
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, device=dev)
    kw = dict(width=200, height=90, spp=2, max_depth=6, jitter=jitter,
              with_stats=True)
    a, seg_a = render_megakernel(scene, cam, 123, **kw)
    b, seg_b = render_megakernel_reference(scene, cam, 123, **kw)
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


def test_rmse_of_means_vs_lax_v2_golden(dev, scene):
    """N=4096 independent 512-spp batches at 64x48, depth 4: the mean must
    match the JAX package's lax-v2 mean golden (the same bound as
    tests/test_parity.py holds the TPU engines to)."""
    oracle = np.load(os.path.join(
        GOLDENS, "tpurt_v2lax_mean_64x48_512spp_d4_N4096.npy"))
    cam = tpu_rt_torch.make_camera(aspect=64 / 48, device=dev)
    acc = torch.zeros((48, 64, 3), dtype=torch.float64, device=dev)
    n = 4096
    for i in range(n):
        acc += render_megakernel(scene, cam, (20000 + i) * (1 << 16),
                                 width=64, height=48, spp=512, max_depth=4,
                                 n_active=N_ACTIVE)
    ours = (acc / n).float().cpu().numpy()
    rmse = float(np.sqrt(((ours - oracle) ** 2).mean()))
    assert rmse <= 1e-3, rmse
    assert abs(float(ours.mean() - oracle.mean())) < 3e-4


@pytest.mark.parametrize("n, spread, cluster_size, jitter", [
    (200, 10.0, 64, True), (5000, 25.0, 8, False), (10000, 30.0, 64, True)],
    ids=["200_C64", "5000_C8_centres", "10k_C64"])
def test_cluster_kernel_matches_plain_on_random_scenes(dev, n, spread,
                                                       cluster_size, jitter):
    """The hierarchy walk against the plain version's brute-force sweep at
    a ragged 200x90 frame, depth 6: with C=8 the 5000-sphere scene has 80
    supers under 10 super-supers."""
    scene = random_spheres(n, seed=n, spread=spread, device=dev)
    cam = tpu_rt_torch.make_camera(position=(0, 4, 20), target=(0, 0, -10),
                                   aspect=200 / 90, device=dev)
    kw = dict(width=200, height=90, spp=2, max_depth=6, jitter=jitter,
              with_stats=True, cluster_size=cluster_size, n_active=n)
    before = render_cluster.launches
    a, seg_a = render_cluster(scene, cam, 2**31 - 2, **kw)
    b, seg_b = render_cluster_reference(scene, cam, 2**31 - 2, **kw)
    torch.cuda.synchronize(dev)
    assert render_cluster.launches == before + 1
    assert a.shape == (90, 200, 3) and a.device == dev
    # no FMA contraction (--fmad=false): bit for bit, segments included
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


def test_cluster_kernel_on_an_all_padding_scene(dev):
    """No valid sphere: every cluster is empty padding and the one global
    row never hits, so every path misses at once."""
    scene = tpu_rt_torch.demo_scene(device=dev)
    scene = scene._replace(valid=torch.zeros_like(scene.valid))
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=dev)
    tables = order_clusters(build_clusters(scene, n_active=1), cam.position)
    assert tables.n_clusters == 64 and not bool(tables.boxes[:, 6].any())
    kw = dict(width=96, height=48, spp=2, max_depth=3, with_stats=True,
              prebuilt=tables, pre_ordered=True)
    a, seg_a = render_cluster(None, cam, 3, **kw)
    b, seg_b = render_cluster_reference(None, cam, 3, **kw)
    assert torch.equal(a, b)
    sky = torch.sqrt(scene.background).expand_as(a)
    assert torch.equal(a, sky)
    assert int(seg_a) == int(seg_b) == 96 * 48 * 2  # one segment per path


def test_cluster_rmse_of_means_vs_cluster_golden(dev, scene):
    """N=4096 independent 512-spp batches of the demo scene through the
    cluster engine (bf16-packed shading attributes, as the golden's) at
    64x48, depth 4, against the JAX package's cluster mean golden."""
    oracle = np.load(os.path.join(
        GOLDENS, "tpurt_cluster_mean_64x48_512spp_d4_N4096.npy"))
    cam = tpu_rt_torch.make_camera(aspect=64 / 48, device=dev)
    tables = order_clusters(build_clusters(scene, n_active=9), cam.position)
    acc = torch.zeros((48, 64, 3), dtype=torch.float64, device=dev)
    n = 4096
    for i in range(n):
        acc += render_cluster(None, cam, (30000 + i) * (1 << 16), width=64,
                              height=48, spp=512, max_depth=4,
                              prebuilt=tables, pre_ordered=True)
    ours = (acc / n).float().cpu().numpy()
    rmse = float(np.sqrt(((ours - oracle) ** 2).mean()))
    assert rmse <= 1e-3, rmse
    assert abs(float(ours.mean() - oracle.mean())) < 3e-4


CORNELL_POSE = dict(position=(0, 2, 2.5), target=(0, 2, -3))
TERRAIN_POSE = dict(position=(0, 6, 6), target=(0, 0, -10))
RAGGED = dict(width=200, height=90, spp=2, max_depth=6, with_stats=True)


@pytest.mark.parametrize("jitter", [True, False], ids=["jitter", "centres"])
def test_megakernel_with_a_mesh_matches_plain(dev, jitter):
    """K1-tri: the Cornell box's 12 triangles beside 2 spheres, bit for
    bit, segments included."""
    spheres, mesh = cornell_box(device=dev)
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, device=dev, **CORNELL_POSE)
    kw = dict(n_active=4, mesh=mesh, n_tri_active=12, jitter=jitter, **RAGGED)
    before = render_megakernel.launches
    a, seg_a = render_megakernel(spheres, cam, 2**31 - 2, **kw)
    b, seg_b = render_megakernel_reference(spheres, cam, 2**31 - 2, **kw)
    torch.cuda.synchronize(dev)
    assert render_megakernel.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


@pytest.mark.parametrize("which", ["terrain_24", "terrain_72", "cornell"])
def test_cluster_kernel_with_a_mesh_matches_plain(dev, which):
    """K2-tri: the triangle walk after the sphere walk against the plain
    version's brute-force sweep, at a ragged 200x90 frame, depth 6; the
    Cornell box's axis-aligned walls have flat boxes."""
    if which == "cornell":
        spheres, mesh = cornell_box(device=dev)
        pose = CORNELL_POSE
    else:
        spheres, mesh = terrain_mesh(n=int(which.split("_")[1]), seed=1,
                                     device=dev)
        pose = TERRAIN_POSE
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, device=dev, **pose)
    before = render_cluster.launches
    a, seg_a = render_cluster(spheres, cam, 2**31 - 2, mesh=mesh, **RAGGED)
    b, seg_b = render_cluster_reference(spheres, cam, 2**31 - 2, mesh=mesh,
                                        **RAGGED)
    torch.cuda.synchronize(dev)
    assert render_cluster.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


def test_kernels_with_an_all_padding_mesh(dev):
    """A mesh with no valid triangle changes neither kernel's image."""
    spheres, mesh = cornell_box(device=dev)
    mesh = mesh._replace(valid=torch.zeros_like(mesh.valid),
                         e1=torch.zeros_like(mesh.e1),
                         e2=torch.zeros_like(mesh.e2))
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=dev, **CORNELL_POSE)
    kw = dict(width=96, height=48, spp=2, max_depth=3, n_active=4)
    alone = render_megakernel(spheres, cam, 3, **kw)
    assert torch.equal(render_megakernel(spheres, cam, 3, mesh=mesh,
                                         n_tri_active=128, **kw), alone)
    tri = order_clusters(build_tri_clusters(mesh, n_active=1), cam.position)
    assert not bool(tri.boxes[:, 6].any())
    alone = render_cluster(spheres, cam, 3, **kw)
    a = render_cluster(spheres, cam, 3, tri_prebuilt=tri, **kw)
    b = render_cluster_reference(spheres, cam, 3, tri_prebuilt=tri, **kw)
    assert torch.equal(a, alone) and torch.equal(a, b)


FLAG_SETS = {
    "refract": dict(enable_refraction=True),
    "dof": dict(enable_dof=True),
    "stratify": dict(stratify=True),
    "all": dict(enable_refraction=True, enable_dof=True, stratify=True),
    # stratify without jitter shoots pixel centres
    "stratify_centres": dict(stratify=True, jitter=False),
}
GLASS = dict(albedo=(0.95, 0.95, 0.95), metallic=0.0, roughness=0.0, ior=1.5)


def glass_cornell(dev):
    """The Cornell box with a glass box (12 triangles) on its floor."""
    spheres, walls = cornell_box(device=dev)
    glass = box(center=(-0.2, 0.36, -1.9), size=(0.7, 0.7, 0.7), device=dev,
                **GLASS)
    return spheres, merge_meshes([walls, glass])


def glass_field(n, seed, spread, dev):
    """random_spheres with every diffuse, non-emissive sphere whose index
    is a positive multiple of 4 made glass (roughness 0, ior 1.5)."""
    scene = random_spheres(n, seed=seed, spread=spread, device=dev)
    idx = torch.arange(scene.capacity, device=dev)
    glass = ((idx % 4 == 0) & (idx > 0) & (scene.metallic <= 0)
             & (scene.emission.amax(dim=-1) <= 0))
    return scene._replace(
        roughness=torch.where(glass, 0.0, scene.roughness),
        ior=torch.where(glass, 1.5, scene.ior))


@pytest.mark.parametrize("mesh", [False, True], ids=["demo", "glass_cornell"])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_megakernel_flags_match_plain(dev, flags, mesh):
    """K1 with refraction, the thin lens and the R2 lattice, alone and
    together, with and without a mesh: bit for bit, segments included."""
    if mesh:
        spheres, m = glass_cornell(dev)
        kw = dict(mesh=m, n_active=4, n_tri_active=24)
        pose = CORNELL_POSE
    else:
        spheres, kw, pose = tpu_rt_torch.demo_scene(device=dev), dict(
            n_active=N_ACTIVE), {}
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, aperture=0.1, device=dev,
                                   **pose)
    before = render_megakernel.launches
    a, seg_a = render_megakernel(spheres, cam, 2**31 - 2, **kw, **RAGGED,
                                 **FLAG_SETS[flags])
    b, seg_b = render_megakernel_reference(spheres, cam, 2**31 - 2, **kw,
                                           **RAGGED, **FLAG_SETS[flags])
    torch.cuda.synchronize(dev)
    assert render_megakernel.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


@pytest.mark.parametrize("mesh", [False, True],
                         ids=["glass_field", "glass_cornell"])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_cluster_kernel_flags_match_plain(dev, flags, mesh):
    """K2 with the same flag sets on a 2000-sphere glass field (refracted
    rays start inside spheres) and on the glass Cornell box."""
    if mesh:
        spheres, m = glass_cornell(dev)
        kw, pose = dict(mesh=m), CORNELL_POSE
    else:
        spheres = glass_field(2000, 2, 15.0, dev)
        kw = dict(n_active=2000)
        pose = dict(position=(0, 3, 14), target=(0, 0, -6))
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, aperture=0.2, device=dev,
                                   **pose)
    before = render_cluster.launches
    a, seg_a = render_cluster(spheres, cam, 2**31 - 2, **kw, **RAGGED,
                              **FLAG_SETS[flags])
    b, seg_b = render_cluster_reference(spheres, cam, 2**31 - 2, **kw,
                                        **RAGGED, **FLAG_SETS[flags])
    torch.cuda.synchronize(dev)
    assert render_cluster.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


def cornell_bulb(dev):
    """The Cornell box with an emissive sphere (a bulb) under its ceiling:
    the walls occlude NEE's shadow rays to it."""
    spheres, walls = cornell_box(device=dev)
    bulb = tpu_rt_torch.make_scene(
        centers=[(-0.8, 0.6, -3.5), (0.8, 0.5, -2.5), (0.0, 3.3, -3.0)],
        radii=[0.6, 0.5, 0.25],
        albedos=[(0.95, 0.95, 0.95), (0.8, 0.7, 0.3), (1.0, 1.0, 1.0)],
        metallics=[1.0, 0.0, 0.0], roughnesses=[0.02, 0.4, 0.0],
        emissions=[(0, 0, 0), (0, 0, 0), (10.0, 9.0, 8.0)],
        background=(0.0, 0.0, 0.0), device=dev)
    return bulb, walls


NEE_SETS = {
    "nee": dict(nee=True),
    "nee_all_flags": dict(nee=True, enable_refraction=True, enable_dof=True,
                          stratify=True),
    "nee_linear": dict(nee=True, gamma=False),
    "linear": dict(gamma=False),
}


@pytest.mark.parametrize("mesh", [False, True], ids=["demo", "cornell_bulb"])
@pytest.mark.parametrize("flags", list(NEE_SETS))
def test_megakernel_nee_matches_plain(dev, flags, mesh):
    """K1 with NEE (the demo scene's 3 lights; the bulb behind the Cornell
    walls), alone, with the PR 4 flags and with linear output, and linear
    output alone: bit for bit, shadow segments included."""
    if mesh:
        spheres, m = cornell_bulb(dev)
        kw, pose = dict(mesh=m, n_active=4, n_tri_active=12), CORNELL_POSE
    else:
        spheres, kw, pose = tpu_rt_torch.demo_scene(device=dev), dict(
            n_active=N_ACTIVE), {}
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, aperture=0.1, device=dev,
                                   **pose)
    before = render_megakernel.launches
    a, seg_a = render_megakernel(spheres, cam, 2**31 - 2, **kw, **RAGGED,
                                 **NEE_SETS[flags])
    b, seg_b = render_megakernel_reference(spheres, cam, 2**31 - 2, **kw,
                                           **RAGGED, **NEE_SETS[flags])
    torch.cuda.synchronize(dev)
    assert render_megakernel.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


@pytest.mark.parametrize("mesh", [False, True],
                         ids=["glass_field", "cornell_bulb"])
@pytest.mark.parametrize("flags", list(NEE_SETS))
def test_cluster_kernel_nee_matches_plain(dev, flags, mesh):
    """K2 with the same sets on the 2000-sphere glass field (about 200
    lights, of which the table takes the first 8) and on the Cornell box
    with a bulb (the shadow rays walk the triangle hierarchy)."""
    if mesh:
        spheres, m = cornell_bulb(dev)
        kw, pose = dict(mesh=m), CORNELL_POSE
    else:
        spheres = glass_field(2000, 2, 15.0, dev)
        kw = dict(n_active=2000)
        pose = dict(position=(0, 3, 14), target=(0, 0, -6))
    cam = tpu_rt_torch.make_camera(aspect=200 / 90, aperture=0.2, device=dev,
                                   **pose)
    before = render_cluster.launches
    a, seg_a = render_cluster(spheres, cam, 2**31 - 2, **kw, **RAGGED,
                              **NEE_SETS[flags])
    b, seg_b = render_cluster_reference(spheres, cam, 2**31 - 2, **kw,
                                        **RAGGED, **NEE_SETS[flags])
    torch.cuda.synchronize(dev)
    assert render_cluster.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)


ADAPTIVE_SETS = {
    "no_flags": {},
    "all_flags": dict(enable_refraction=True, enable_dof=True, stratify=True),
    "nee_all_flags": dict(nee=True, enable_refraction=True, enable_dof=True,
                          stratify=True),
}
# 256x128: 8 megakernel tiles, or 2 x 4 cluster screen blocks
ADAPTIVE = dict(width=256, height=128, spp=2, max_depth=4, with_stats=True)
HALF = np.array([1, 0, 0, 1, 1, 0, 1, 0], np.int32)


def kernel_and_plain(kernel, plain, *args, **kw):
    """Both versions on the same inputs: bit for bit, segments included;
    returns the kernel's (image, segments)."""
    a, seg_a = kernel(*args, **kw)
    b, seg_b = plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)
    return a, seg_a


@pytest.mark.parametrize("mesh", [False, True], ids=["demo", "cornell_bulb"])
@pytest.mark.parametrize("flags", list(ADAPTIVE_SETS))
def test_megakernel_masks_and_bands_match_plain(dev, flags, mesh):
    """K1 under a tile mask, in a band whose last tile is ragged, and in a
    masked band, in every instantiation: bit for bit against the plain
    version; the masked kernel's active tiles equal the unmasked kernel's
    and its skipped tiles are zeros."""
    if mesh:
        spheres, m = cornell_bulb(dev)
        kw, pose = dict(mesh=m, n_active=4, n_tri_active=12), CORNELL_POSE
    else:
        spheres, kw, pose = tpu_rt_torch.demo_scene(device=dev), dict(
            n_active=N_ACTIVE), {}
    cam = tpu_rt_torch.make_camera(aspect=2.0, aperture=0.1, device=dev,
                                   **pose)
    kw.update(ADAPTIVE, **ADAPTIVE_SETS[flags])
    args = (spheres, cam, 2**31 - 2)
    pair = (render_megakernel, render_megakernel_reference)
    before = render_megakernel.launches
    full, _ = render_megakernel(*args, **kw)
    masked, _ = kernel_and_plain(*pair, *args, tile_mask=HALF, **kw)
    on = torch.from_numpy(np.repeat(HALF != 0, 4096)).to(dev).reshape(128,
                                                                      256)
    assert torch.equal(masked[on], full[on]) and not masked[~on].any()
    # 40 rows from row 88: 10240 pixels, the third tile ragged
    kernel_and_plain(*pair, *args, rows=40, row_offset=88, **kw)
    kernel_and_plain(*pair, *args, rows=40, row_offset=88,
                     tile_mask=torch.tensor([1, 0, 1], dtype=torch.int32),
                     **kw)
    assert render_megakernel.launches == before + 4


@pytest.mark.parametrize("mesh", [False, True],
                         ids=["glass_field", "cornell_bulb"])
@pytest.mark.parametrize("flags", list(ADAPTIVE_SETS))
def test_cluster_kernel_masks_and_bands_match_plain(dev, flags, mesh):
    """K2 under a mask of its screen blocks and in bands of 32 rows, in
    every instantiation: bit for bit against the plain version; the
    masked kernel's active blocks equal the unmasked kernel's, and the
    kernel's bands stitched together equal its full frame."""
    if mesh:
        spheres, m = cornell_bulb(dev)
        kw, pose = dict(mesh=m), CORNELL_POSE
    else:
        spheres = glass_field(2000, 2, 15.0, dev)
        kw = dict(n_active=2000)
        pose = dict(position=(0, 3, 14), target=(0, 0, -6))
    cam = tpu_rt_torch.make_camera(aspect=2.0, aperture=0.2, device=dev,
                                   **pose)
    kw.update(ADAPTIVE, **ADAPTIVE_SETS[flags])
    args = (spheres, cam, 2**31 - 2)
    pair = (render_cluster, render_cluster_reference)
    full, seg_full = render_cluster(*args, **kw)
    masked, _ = kernel_and_plain(*pair, *args, tile_mask=HALF, **kw)
    tmap, _ = cluster_tile_map(256, 128, device=dev)
    on = torch.from_numpy(HALF).to(dev)[tmap.long()] != 0
    assert torch.equal(masked[on], full[on]) and not masked[~on].any()
    bands = [kernel_and_plain(*pair, *args, rows=32, row_offset=o, **kw)
             for o in (0, 32, 64, 96)]
    assert torch.equal(torch.cat([b for b, _ in bands]), full)
    assert sum(int(s) for _, s in bands) == int(seg_full)
    kernel_and_plain(*pair, *args, rows=64, row_offset=32,
                     tile_mask=HALF[:4], **kw)


def test_display_stack_at_4k_uhd(dev):
    """3840x2160x3 values exceed torch.quantile's 2^24: the enhanced row is
    the float64 numpy percentile stretch of the tone-mapped row."""
    rng = np.random.default_rng(0)
    acc = torch.from_numpy(rng.uniform(0, 1.5, (2160, 3840, 3)).astype(
        np.float32)).to(dev)
    stack = display_stack(acc, 1.5)
    torch.cuda.synchronize(dev)
    assert stack.shape == (2, 2160, 3840, 3) and stack.device == dev
    disp = stack[0].cpu().numpy().astype(np.float64)
    lo, hi = np.percentile(disp, [2.0, 98.0])
    np.testing.assert_allclose(stack[1].cpu().numpy(),
                               np.clip((disp - lo) / (hi - lo), 0.0, 1.0),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 128), (40_000,)],
                         ids=["one_tpu_block", "40k"])
@pytest.mark.parametrize("depth", [0, 8, 64, 1000])
def test_fma_kernel_matches_plain(dev, shape, depth):
    """K3 rounds each step once (__fmaf_rn), the plain version in float64
    once: bit for bit."""
    x = torch.from_numpy(np.random.default_rng(depth).uniform(
        0.25, 1.0, shape).astype(np.float32)).to(dev)
    before = rl.fma_chains.launches
    a = rl.fma_chains(x, depth)
    b = rl.fma_chains_reference(x, depth)
    torch.cuda.synchronize(dev)
    assert rl.fma_chains.launches == before + 1
    assert a.shape == x.shape and a.device == dev
    assert torch.equal(a, b), int((a != b).sum())


def test_measured_fma_rate_near_theoretical(dev):
    attrs = rl.card_fp32(dev)
    assert attrs.sms > 0 and attrs.clock_khz > 0
    assert attrs.fma_blocks_per_sm >= 1
    slope = rl.measure_fma_ops(device=dev)
    assert slope.launches == rl.FMA_WARMUP + 10
    rate = slope.ops_per_s
    peak = rl.theoretical_fp32_ops(dev)
    assert peak == attrs.sms * 128 * attrs.clock_khz * 1e3
    assert 0.5 <= rate / peak <= 1.05, (rate, peak)


def denoised_rows_agree(kernel_rows, plain_rows, methods):
    """Each method's uint8 rows on the card against the CPU's: gaussian and
    median equal; bilateral and nlmeans (exp rounds apart on the two
    devices) within 1 and equal in 99.9% of the values."""
    for m, a, b in zip(methods, kernel_rows, plain_rows):
        d = (a.cpu().int() - b.int()).abs()
        if m in ("gaussian", "median"):
            assert int(d.max()) == 0, m
        else:
            assert int(d.max()) <= 1, m
            assert float((d == 0).float().mean()) >= 0.999, m


@pytest.mark.parametrize("grid_scale", [1, 2])
def test_display_stack_denoisers_cuda_vs_cpu(dev, scene, grid_scale):
    methods = ("bilateral", "nlmeans", "gaussian", "median")
    cam = tpu_rt_torch.make_camera(aspect=320 / 240, device=dev)
    acc = render_megakernel(scene, cam, 5, width=320, height=240, spp=8,
                            max_depth=4, n_active=N_ACTIVE)
    ours = display_stack(acc, 1.5, methods=methods, as_uint8=True,
                         grid_scale=grid_scale)
    plain = display_stack(acc.cpu(), 1.5, methods=methods, as_uint8=True,
                          grid_scale=grid_scale)
    assert ours.device == dev and ours.dtype == torch.uint8
    assert torch.equal(ours[:2].cpu(), plain[:2])
    if grid_scale == 1:
        rows = (ours[2:], plain[2:])
    else:
        q, p = (unpack_grid(s[2], methods, grid_scale) for s in (ours, plain))
        rows = ([q[m] for m in methods],
                                     [p[m] for m in methods])
    denoised_rows_agree(*rows, methods)


@pytest.mark.parametrize("which", ["demo", "cornell"])
def test_render_aovs_cuda_vs_cpu(dev, which):
    if which == "demo":
        spheres, mesh = tpu_rt_torch.demo_scene(device=dev), None
        pose = {}
    else:
        spheres, mesh = cornell_box(device=dev)
        pose = CORNELL_POSE
    cam = tpu_rt_torch.make_camera(aspect=320 / 240, device=dev, **pose)
    to_cpu = (lambda t: None if t is None
              else type(t)(*(f.cpu() for f in t)))
    a = render_aovs(spheres, cam, 320, 240, mesh=mesh)
    b = render_aovs(to_cpu(spheres), to_cpu(cam), 320, 240,
                    mesh=to_cpu(mesh))
    assert a["depth"].device == dev
    same = (a["hit"].cpu() == b["hit"]) & (a["object_id"].cpu()
                                            == b["object_id"])
    assert float(same.float().mean()) >= 0.9999
    torch.testing.assert_close(a["depth"].cpu()[same], b["depth"][same],
                               rtol=1e-5, atol=0)
    for k in ("normal", "albedo"):
        torch.testing.assert_close(a[k].cpu()[same], b[k][same], rtol=0,
                                   atol=1e-5)
    img = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (240, 320, 3)).astype(np.float32))
    joint = Denoiser(device=dev).denoise(img, "joint", aovs=a)
    joint_cpu = Denoiser(device="cpu").denoise(img, "joint", aovs=b)
    d = np.abs(joint - joint_cpu)
    assert d.max() <= 1 / 255 and (d <= 1e-5).mean() >= 0.999


@pytest.mark.parametrize("size", [(640, 480), (320, 240), (1920, 1080)],
                         ids=["640x480", "320x240", "1080p"])
def test_pixel_uv_and_rays_cuda_equal_cpu(dev, size):
    """The AOVs' pixel-centre rays made on the card equal the CPU's bit for
    bit (pixel_uv divides by device tensors, a true division on both)."""
    from tpu_rt_torch.core import camera as cammod

    w, h = size
    cam = tpu_rt_torch.make_camera(aspect=w / h, device=dev)
    u, v = cammod.pixel_uv(w, h, None, device=dev)
    uc, vc = cammod.pixel_uv(w, h, None, device="cpu")
    assert torch.equal(u.cpu(), uc) and torch.equal(v.cpu(), vc)
    d = cammod.generate_rays(cam, u.reshape(-1), v.reshape(-1))[1]
    dc = cammod.generate_rays(type(cam)(*(f.cpu() for f in cam)),
                              uc.reshape(-1), vc.reshape(-1))[1]
    assert torch.equal(d.cpu(), dc), int((d.cpu() != dc).sum())


# ---- the walk: IEEE sqrt, ties, visit counts (csrc/cluster.cu) ----

def test_vecmath_sqrt_cuda_equals_cpu_and_ieee(dev):
    """vecmath.sqrt on the card equals the CPU's and numpy's correctly
    rounded square root (the kernels' sqrtf), subnormals and inf
    included."""
    from tpu_rt_torch.core import vecmath

    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(0.0, 4.0, 1_000_000),
                        np.exp(rng.uniform(-87.0, 88.0, 1_000_000)),
                        [0.0, np.inf, 1e-45, 1e-40]]).astype(np.float32)
    t = torch.from_numpy(x)
    ours = vecmath.sqrt(t.to(dev)).cpu()
    assert torch.equal(ours, vecmath.sqrt(t))
    np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                  np.sqrt(x).view(np.int32))


TIE_SETS = {"depth1_row": (dict(width=256, height=1, spp=1, max_depth=1,
                                jitter=False), {}),
            "jitter_d4": (dict(width=256, height=128, spp=4, max_depth=4),
                          {}),
            "nee_flags": (dict(width=256, height=128, spp=4, max_depth=4),
                          dict(nee=True, enable_refraction=True,
                               stratify=True))}


@pytest.mark.parametrize("case", list(TIE_SETS))
def test_cluster_tie_scene_matches_plain(dev, case):
    """The tie scene (core/scenes.py:tie_scene): one sphere in two
    clusters, two triangles whose shared edge the one-row frame's rays
    run along. The kernel's near-to-far walk takes the first of equal hits
    in storage order, as the plain version's sweep does: bit for bit,
    segments included, also with NEE's any-hit shadow rays."""
    from tpu_rt_torch.core.scenes import TIE_CAM, tie_scene

    spheres, mesh = tie_scene(device=dev)
    cam = tpu_rt_torch.make_camera(**TIE_CAM, device=dev)
    shape, flags = TIE_SETS[case]
    kw = dict(prebuilt=order_clusters(build_clusters(spheres, cluster_size=8),
                                      cam.position),
              tri_prebuilt=order_clusters(
                  build_tri_clusters(mesh, cluster_size=8), cam.position),
              pre_ordered=True, with_stats=True, **shape, **flags)
    if flags.get("nee"):
        from tpu_rt_torch.ops.cluster import light_table
        kw["lights"] = light_table(spheres)
    a, seg_a = render_cluster(None, cam, 7, **kw)
    b, seg_b = render_cluster_reference(None, cam, 7, **kw)
    torch.cuda.synchronize(dev)
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)
    assert float(a.max()) > 0


VISIT_SETS = {
    "spheres_10k": (dict(n=10000), {}),
    "spheres_10k_nee_flags": (dict(n=10000), dict(
        nee=True, enable_refraction=True, enable_dof=True, stratify=True)),
    "terrain_72": (dict(terrain=72), {}),
    "terrain_72_nee": (dict(terrain=72), dict(nee=True)),
}


@pytest.mark.parametrize("case", list(VISIT_SETS))
def test_cluster_visit_counts_match_walk_reference(dev, case):
    """The counting instantiation's per-tile visit counts (slab tests per
    level, group boxes included, sphere and triangle tests, path and shadow
    rays) equal
    walk_visits_reference's over the plain version's rays, at 256x128/4spp;
    the counting kernel's image and segments are the timed kernel's."""
    what, flags = VISIT_SETS[case]
    if "n" in what:
        spheres = random_spheres(what["n"], seed=1, spread=30.0, device=dev)
        mesh, pose = None, dict(position=(0, 6, 40), target=(0, 0, -18))
    else:
        spheres, mesh = terrain_mesh(n=what["terrain"], seed=1, device=dev)
        pose = TERRAIN_POSE
    cam = tpu_rt_torch.make_camera(aspect=2.0, aperture=0.1, device=dev,
                                   **pose)
    kw = dict(width=256, height=128, spp=4, max_depth=4, mesh=mesh,
              with_stats=True, **flags)
    a, seg_a = render_cluster(spheres, cam, 5, **kw)
    b, seg_b, vis = render_cluster(spheres, cam, 5, with_visits=True, **kw)
    c, seg_c, ref = render_cluster_reference(spheres, cam, 5,
                                             with_visits=True, **kw)
    torch.cuda.synchronize(dev)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert int(seg_a) == int(seg_b) == int(seg_c)
    assert vis.shape == ref.shape == (8, 2, 7)
    assert torch.equal(vis[..., :6], ref[..., :6]), (
        vis.sum(0).tolist(), ref.sum(0).tolist())
    # the warps issue at least 1/32 of their lanes' primitive tests: the
    # sphere tests without a mesh, the triangle tests with one
    lanes = vis[..., 5 if mesh is not None else 4].sum(0)
    warps = vis[..., 6].sum(0)
    assert bool((warps * 32 >= lanes).all()) and bool((warps <= lanes).all())
    if flags.get("nee"):
        assert int(vis[:, 1, 4:6].sum()) > 0


# the triangle walk's builds: each <kTris = true> instantiation, and the
# NEE one under a tile mask, in a band of rows and counting its visits
TRI_WALK_BUILDS = {
    "plain": {},
    "flags": dict(enable_refraction=True, enable_dof=True, stratify=True),
    "nee": dict(nee=True),
    "nee_flags": dict(nee=True, enable_refraction=True, enable_dof=True,
                      stratify=True),
    "nee_masked": dict(nee=True, tile_mask=np.array([1, 0, 0, 1, 1, 0, 1, 0],
                                                    np.int32)),
    "nee_band": dict(nee=True, rows=64, row_offset=32),
    "nee_counting": dict(nee=True, with_visits=True),
}
# the terrain seen from above (every primary ray hits it) and from the
# cell's pose (about half the frame is sky: those paths end at the first
# bounce and their lanes serve in the walk's teams)
TRI_WALK_VIEWS = {"ground": dict(position=(0, 10, -4), target=(0, 0, -10)),
                  "half_sky": TERRAIN_POSE}


@pytest.mark.parametrize("view", list(TRI_WALK_VIEWS))
@pytest.mark.parametrize("build", list(TRI_WALK_BUILDS))
def test_cluster_triangle_walk_matches_plain(dev, build, view):
    """The warp's walk of the triangle table (csrc/cluster.cu team_walk) on
    the 10,082-triangle terrain under its 3 spheres at 256x128, 8 spp,
    depth 4, through every triangle instantiation: image and segments bit
    for bit against the plain version's brute-force sweep."""
    spheres, mesh = terrain_mesh(n=72, seed=1, device=dev)
    cam = tpu_rt_torch.make_camera(aspect=2.0, aperture=0.1, device=dev,
                                   **TRI_WALK_VIEWS[view])
    kw = dict(width=256, height=128, spp=8, max_depth=4, mesh=mesh,
              with_stats=True, **TRI_WALK_BUILDS[build])
    before = render_cluster.launches
    a, seg_a = render_cluster(spheres, cam, 2**31 - 5, **kw)[:2]
    kw.pop("with_visits", None)
    b, seg_b = render_cluster_reference(spheres, cam, 2**31 - 5, **kw)
    torch.cuda.synchronize(dev)
    assert render_cluster.launches == before + 1
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)
    assert float(a.max()) > 0


def test_cluster_triangle_rows_off_16_bytes_are_refused(dev):
    """The triangle walk reads its cluster boxes 16 bytes at a time, so the
    launcher refuses a triangle table whose rows do not start on a 16-byte
    boundary (a view one word into a buffer) instead of faulting; the same
    rows on the boundary render."""
    from tpu_rt_torch.core.scenes import TIE_CAM, tie_scene

    spheres, mesh = tie_scene(device=dev)
    cam = tpu_rt_torch.make_camera(**TIE_CAM, device=dev)
    tri = order_clusters(build_tri_clusters(mesh, cluster_size=8),
                         cam.position)
    buf = torch.empty(tri.attr.numel() + 1, dtype=tri.attr.dtype, device=dev)
    off = buf[1:].view(tri.attr.shape)
    off.copy_(tri.attr)
    kw = dict(prebuilt=order_clusters(build_clusters(spheres, cluster_size=8),
                                      cam.position),
              pre_ordered=True, width=128, height=32, spp=1, max_depth=2)
    render_cluster(None, cam, 7, tri_prebuilt=tri, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        render_cluster(None, cam, 7, tri_prebuilt=tri._replace(attr=off),
                       **kw)
    torch.cuda.synchronize(dev)


@pytest.mark.parametrize("gamma", [True, False])
def test_cluster_samples_in_chunks_bit_for_bit(dev, gamma, monkeypatch):
    """A frame whose samples do not fit the scratch runs in chunks (here 3,
    3 and 2 of 8 samples, one launch each); the mean pass carries each
    pixel's running sum across them in sample order, so the image equals
    the one-chunk frame's and the plain version's bit for bit, the gamma
    mean and the linear one, segments and visit counts included."""
    from tpu_rt_torch.ops import cluster as cm

    spheres = random_spheres(10000, seed=1, spread=30.0, device=dev)
    cam = tpu_rt_torch.make_camera(aspect=2.0, position=(0, 6, 40),
                                   target=(0, 0, -18), device=dev)
    kw = dict(width=256, height=128, spp=8, max_depth=4, nee=True,
              stratify=True, gamma=gamma, with_stats=True)
    a, seg_a, vis_a = render_cluster(spheres, cam, 13, with_visits=True,
                                     **kw)
    ref, seg_ref = render_cluster_reference(spheres, cam, 13, **kw)
    monkeypatch.setattr(cm, "SCRATCH_LANES", 3 * 8 * cm.TILE)
    before = render_cluster.launches
    b, seg_b, vis_b = render_cluster(spheres, cam, 13, with_visits=True,
                                     **kw)
    assert render_cluster.launches - before == 3
    torch.cuda.synchronize(dev)
    assert torch.equal(a, b) and torch.equal(a, ref)
    assert int(seg_a) == int(seg_b) == int(seg_ref)
    assert torch.equal(vis_a[..., :6], vis_b[..., :6])


ALL_FLAGS = dict(enable_refraction=True, enable_dof=True, stratify=True)
# each <kTris, kFlags, kNee> instantiation of the megakernel
K1_BUILDS = {
    "spheres": (False, {}),
    "spheres_flags": (False, ALL_FLAGS),
    "spheres_nee": (False, dict(nee=True, **ALL_FLAGS)),
    "tris": (True, {}),
    "tris_flags": (True, ALL_FLAGS),
    "tris_nee": (True, dict(nee=True, **ALL_FLAGS)),
}


def k1_case(dev, mesh):
    """The demo scene, or the Cornell box with a bulb and its walls; the
    render's keywords and a camera with a thin lens."""
    if mesh:
        spheres, m = cornell_bulb(dev)
        kw, pose = dict(mesh=m, n_active=4, n_tri_active=12), CORNELL_POSE
    else:
        spheres, kw, pose = tpu_rt_torch.demo_scene(device=dev), dict(
            n_active=N_ACTIVE), {}
    cam = tpu_rt_torch.make_camera(aspect=2.0, aperture=0.1, device=dev,
                                   **pose)
    return spheres, cam, kw


def kernel_tile_segments(*args, **kw):
    """The timed kernel's per-tile segment counts of a whole-tile frame:
    the frame's count under a mask that leaves one tile on, tile by
    tile."""
    n_tiles = -(-kw["width"] * kw["height"] // 4096)
    counts = []
    for t in range(n_tiles):
        one = torch.zeros(n_tiles, dtype=torch.int32)
        one[t] = 1
        counts.append(int(render_megakernel(*args, tile_mask=one, **kw)[1]))
    return torch.tensor(counts)


@pytest.mark.parametrize("spp", [1, 3, 8, 13, 33, 40])
@pytest.mark.parametrize("build", list(K1_BUILDS))
def test_megakernel_per_sample_threads_bit_for_bit(dev, build, spp):
    """One thread per (pixel, sample), the pixel's samples summed by a
    shuffle chain in sample order: every instantiation at spp 1, 3, 8, 13,
    33 and 40 (3 and 13 leave lanes of a warp idle; 33 and 40 run a
    second, ragged round of 32-lane groups) equals the plain version bit
    for bit, images and per-tile segments, whole, under a tile mask, and
    in a masked band whose last tile is ragged."""
    mesh, flags = K1_BUILDS[build]
    spheres, cam, kw = k1_case(dev, mesh)
    kw.update(width=256, height=128, spp=spp, max_depth=4, with_stats=True,
              **flags)
    args = (spheres, cam, 2**31 - 2)
    pair = (render_megakernel, render_megakernel_reference)
    before = render_megakernel.launches
    kernel_and_plain(*pair, *args, **kw)
    kernel_and_plain(*pair, *args, tile_mask=HALF, **kw)
    kernel_and_plain(*pair, *args, rows=40, row_offset=88,
                     tile_mask=torch.tensor([1, 0, 1], dtype=torch.int32),
                     **kw)
    assert render_megakernel.launches == before + 3
    ref = megakernel_visits_reference(*args, **kw)
    tiles = kernel_tile_segments(*args, **kw)
    assert torch.equal(tiles, ref[:, :, 0].sum(1).cpu()), (
        tiles.tolist(), ref[:, :, 0].sum(1).tolist())


# chip_smoke.py's timed frames: on an H100 (132 SMs) samples_per_lane
# gives a lane 2 samples at 640x480/8spp (groups of 4 lanes) and 4 at
# 1080p/4spp (a lane per pixel, no shuffle), 1 with NEE
K1_TIMED_SHAPES = {"640x480_8spp": dict(width=640, height=480, spp=8),
                   "1080p_4spp": dict(width=1920, height=1080, spp=4)}


@pytest.mark.parametrize("shape", list(K1_TIMED_SHAPES))
@pytest.mark.parametrize("build", list(K1_BUILDS))
def test_megakernel_timed_shapes_bit_for_bit(dev, build, shape):
    """Every instantiation at the timed frames, where a lane traces
    several samples in rounds or holds its pixel alone: the timed kernel
    equals the plain version bit for bit, image and segments; the counting
    kernel equals the timed one, and its per-tile counts the plain
    version's."""
    mesh, flags = K1_BUILDS[build]
    spheres, cam, kw = k1_case(dev, mesh)
    kw.update(max_depth=4, with_stats=True, **K1_TIMED_SHAPES[shape],
              **flags)
    args = (spheres, cam, 2**31 - 2)
    a, seg_a = render_megakernel(*args, **kw)
    c, seg_c, vis = render_megakernel(*args, with_visits=True, **kw)
    b, seg_b, ref = render_megakernel_reference(*args, with_visits=True,
                                                **kw)
    torch.cuda.synchronize(dev)
    assert torch.equal(a, b), int((a != b).sum())
    assert int(seg_a) == int(seg_b)
    assert torch.equal(c, a) and int(seg_c) == int(seg_a)
    assert torch.equal(vis[..., :3], ref[..., :3]), (
        vis.sum(0).tolist(), ref.sum(0).tolist())


K1_VISIT_SETS = {
    "demo_8spp": (False, dict(spp=8)),
    "demo_nee_flags": (False, dict(spp=3, nee=True, **ALL_FLAGS)),
    "cornell_bulb_nee": (True, dict(spp=8, nee=True)),
    "cornell_bulb_masked_band": (True, dict(
        spp=4, nee=True, stratify=True, rows=40, row_offset=88,
        tile_mask=torch.tensor([1, 0, 1], dtype=torch.int32))),
}


@pytest.mark.parametrize("case", list(K1_VISIT_SETS))
def test_megakernel_visit_counts_match_reference(dev, case):
    """The counting instantiation's image and segments are the timed
    kernel's; its per-tile counts (path and shadow segments, sphere and
    triangle tests, a shadow ray's up to its first blocker) equal
    megakernel_visits_reference's over the plain version's rays; the warps
    issue between 1/32 of their lanes' tests and all of them."""
    mesh, extra = K1_VISIT_SETS[case]
    spheres, cam, kw = k1_case(dev, mesh)
    kw.update(width=256, height=128, max_depth=4, with_stats=True, **extra)
    a, seg_a = render_megakernel(spheres, cam, 5, **kw)
    b, seg_b, vis = render_megakernel(spheres, cam, 5, with_visits=True, **kw)
    ref = megakernel_visits_reference(spheres, cam, 5, **kw)
    torch.cuda.synchronize(dev)
    assert torch.equal(a, b) and int(seg_a) == int(seg_b)
    assert vis.shape == ref.shape and vis.dtype == torch.int64
    assert torch.equal(vis[..., :3], ref[..., :3]), (
        vis.sum(0).tolist(), ref.sum(0).tolist())
    lanes = vis[..., 1:3].sum(-1).sum(0)
    warps = vis[..., 3].sum(0)
    assert bool((warps * 32 >= lanes).all()) and bool((warps <= lanes).all())
    if extra.get("nee"):
        assert int(vis[:, 1, 1:3].sum()) > 0


def test_app_session_on_card_equals_hand_chain(dev):
    """A headless RayTracerInteraction on the card at 640x480/8spp/d4 ends
    done at 32 samples with the accumulator of RayTracer.render_device ->
    accumulate at the same seeds, bit for bit, launching K1 once a batch."""
    from tpu_rt_torch.api import RayTracer
    from tpu_rt_torch.app import RayTracerInteraction, SceneManager
    from tpu_rt_torch.render.frame import accumulate

    rti = RayTracerInteraction(640, 480, device=dev)
    render_megakernel.launches = 0
    frames = []
    try:
        rti.start_rendering()
        deadline = time.time() + 120
        while time.time() < deadline:
            f = rti.get_frame()
            if f is None:
                time.sleep(0.01)
                continue
            frames.append(f)
            if f.get("done"):
                break
    finally:
        rti.stop_rendering()
    assert frames and frames[-1].get("done")
    assert rti.total_samples == 32 and render_megakernel.launches == 4
    rt = RayTracer(device=dev)
    rt.set_scene(SceneManager.create_interactive_scene())
    acc, total = None, 0
    for _ in range(4):
        acc, total = accumulate(acc, total, rt.render_device(640, 480, 8, 4),
                                8)
    assert rti._acc_dev.device == acc.device
    assert torch.equal(rti._acc_dev, acc)
    last = [f for f in frames if "display" in f][-1]
    assert last["samples"] == 32 and last["display"].shape == (480, 640, 3)


def test_gui_render_thread_gets_a_640x480_frame_from_the_card(dev):
    """The port's gui.py against tests/pyqt5_stub/: the RenderThread polls
    the session rendering on the card and the main display receives its
    first real 640x480 frame (the card's machine has no PyQt5)."""
    stub = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "pyqt5_stub")

    def purge():
        return {k: sys.modules.pop(k) for k in list(sys.modules)
                if k.split(".")[0] == "PyQt5"
                or k == "tpu_rt_torch.app.gui"}

    saved = purge()
    sys.path.insert(0, stub)
    try:
        import tpu_rt_torch.app.gui as gui

        assert gui.HAVE_QT
        render_megakernel.launches = 0
        g = gui.GUI(640, 480, device=dev)
        try:
            deadline = time.time() + 120
            while g.main_display.pixmap() is None and time.time() < deadline:
                time.sleep(0.05)
            pm = g.main_display.pixmap()
            assert pm is not None, "no frame reached the main display"
            img = pm.image()
            assert (img.width(), img.height()) == (640, 480)
            assert g.enhanced_display.pixmap() is not None
            assert "Samples" in g.status_label.text()
            assert render_megakernel.launches >= 1
            assert g.raytracer._acc_dev.device == dev
        finally:
            g.close()
        assert not g.raytracer.render_state.is_rendering
    finally:
        sys.path.remove(stub)
        purge()
        sys.modules.update(saved)


# ---- the lax engine (plain torch, no kernel) ----

def test_threefry_bits_cuda_equal_cpu(dev):
    """Integer hashing: the card's threefry words equal the CPU's exactly,
    for keys, splits, folds and draws; the uniforms too."""
    from tpu_rt_torch.core import rng

    for seed in (0, 7, 2**31 - 2):
        k_dev, k_cpu = rng.key(seed, device=dev), rng.key(seed, device="cpu")
        for shape in ((4096,), (640, 2), (48, 64, 2)):
            assert torch.equal(rng.bits(k_dev, shape).cpu(),
                               rng.bits(k_cpu, shape))
            assert torch.equal(rng.uniform(k_dev, shape).cpu(),
                               rng.uniform(k_cpu, shape))
        assert torch.equal(rng.split(k_dev, 5).cpu(), rng.split(k_cpu, 5))
        ks = rng.fold_in(k_dev, torch.arange(8, device=dev))
        assert ks.device == dev
        assert torch.equal(ks.cpu(), rng.fold_in(k_cpu, torch.arange(8)))


def test_lbvh_hits_cuda_equal_cpu(dev):
    """The LBVH built and traversed on the card finds the CPU's primitives
    at the CPU's t, for spheres and for triangles."""
    from tpu_rt_torch.ops import bvh, triangle

    s_cpu = random_spheres(2000, seed=3, device="cpu")
    _, m_cpu = terrain_mesh(n=24, seed=1, device="cpu")
    s_dev = random_spheres(2000, seed=3, device=dev)
    _, m_dev = terrain_mesh(n=24, seed=1, device=dev)
    g = np.random.default_rng(5)
    o = g.normal(size=(20000, 3))
    o = 25.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = g.uniform(-8.0, 8.0, (20000, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    for name, hit in (("spheres", lambda s, m, o_, d_: bvh.intersect_spheres_bvh(
            s, bvh.scene_lbvh(s), o_, d_)),
                      ("triangles", lambda s, m, o_, d_: triangle.intersect_mesh_bvh(
            m, triangle.mesh_lbvh(m), o_, d_))):
        t_dev, p_dev = hit(s_dev, m_dev, o.to(dev), d.to(dev))
        t_cpu, p_cpu = hit(s_cpu, m_cpu, o, d)
        assert t_dev.device == dev
        assert torch.equal(p_dev.cpu(), p_cpu), name
        assert torch.equal(t_dev.cpu(), t_cpu), name
        assert 0 < int((p_cpu >= 0).sum()) < 20000


def test_render_lax_returns_a_cuda_tensor(dev, scene):
    """render(engine="lax") renders on the card (no CPU fallback), and
    against the CPU port at the same seed: 99.9% of values within 1e-4,
    segments within 0.1%."""
    from tpu_rt_torch.render.frame import render

    kw = dict(width=96, height=64, spp=2, max_depth=4, engine="lax",
              with_stats=True, use_bvh=True)
    img, segs = render(scene, tpu_rt_torch.make_camera(aspect=1.5, device=dev),
                       11, **kw)
    assert img.device == dev and img.shape == (64, 96, 3)
    ref, segs_cpu = render(tpu_rt_torch.demo_scene(device="cpu"),
                           tpu_rt_torch.make_camera(aspect=1.5, device="cpu"),
                           11, **kw)
    frac = float(((img.cpu() - ref).abs() <= 1e-4).float().mean())
    assert frac >= 0.999, frac
    assert abs(int(segs) - int(segs_cpu)) <= 0.001 * int(segs_cpu)


@pytest.mark.parametrize("engine", ["pallas", "cluster"])
def test_render_sharded_kernel_engines_equal_their_bands(dev, engine):
    """render_sharded over a (2, 2) mesh of four cuda:0 entries: one
    kernel launch a shard (one chunk each), and the frame bit for bit the
    composition of the kernel's bands at each shard's seed (summed in
    sample order, averaged, gamma'd) and of the plain version's bands."""
    from tpu_rt_torch.core import rng
    from tpu_rt_torch.core import vecmath as vm
    from tpu_rt_torch.parallel import make_mesh, render_sharded
    from tpu_rt_torch.parallel.mesh import shard_keys, shard_seed

    if engine == "pallas":
        scene = tpu_rt_torch.demo_scene(device=dev)
        pose, extra = {}, dict(n_active=N_ACTIVE)
        kernel, plain = render_megakernel, render_megakernel_reference
    else:
        scene = random_spheres(2000, seed=1, spread=20.0, device=dev)
        pose, extra = dict(position=(0, 6, 40), target=(0, 0, -18)), {}
        kernel, plain = render_cluster, render_cluster_reference
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=dev, **pose)
    shape = dict(width=256, height=128, spp=4, max_depth=4)
    counter = kernel.launches
    out = render_sharded(scene, cam, rng.key(11, device=dev),
                         make_mesh(2, 2, devices=[dev] * 4), engine=engine,
                         **shape, **extra)
    img = out.gather()
    assert kernel.launches == counter + 4
    assert img.device == dev and img.shape == (128, 256, 3)
    keys = shard_keys(rng.key(11, device="cpu"), 2, 2)
    for fn in (kernel, plain):
        bands = []
        for ti in range(2):
            acc = None
            for si in range(2):
                band = fn(scene, cam, shard_seed(keys[ti, si]), gamma=False,
                          rows=64, row_offset=64 * ti,
                          **dict(shape, spp=2), **extra)
                acc = band if acc is None else acc + band
            bands.append(acc / torch.tensor(2.0, device=dev))
        ref = torch.clamp(vm.sqrt(torch.clamp_min(torch.cat(bands), 0.0)),
                          0.0, 1.0)
        assert torch.equal(img, ref), (fn.__name__, int((img != ref).sum()))


def test_render_sharded_lax_cuda_vs_cpu(dev):
    """The default (lax) engine over a (2, 2) mesh of cuda:0 entries
    against the same mesh of CPU entries: 99.9% of values within 1e-4,
    segments within 0.1%."""
    from tpu_rt_torch.core import rng
    from tpu_rt_torch.parallel import make_mesh, render_sharded

    outs = []
    for d in (dev, torch.device("cpu")):
        img = render_sharded(
            tpu_rt_torch.demo_scene(device=d),
            tpu_rt_torch.make_camera(aspect=2.0, device=d), rng.key(11,
                                                                    device=d),
            make_mesh(2, 2, devices=[d] * 4), width=64, height=32, spp=4,
            max_depth=4, nee=True, stratify=True)
        assert all(b.device == d for b in img.bands.values())
        outs.append((img.gather(torch.device("cpu")), img.segments))
    frac = float(((outs[0][0] - outs[1][0]).abs() <= 1e-4).float().mean())
    assert frac >= 0.999, frac
    assert abs(outs[0][1] - outs[1][1]) <= 0.001 * outs[1][1]


def _api_field(n):
    """An api Scene of ``n`` random spheres (the cluster engine past 64)."""
    from tpu_rt_torch.api import Material, Scene, Sphere, Vector3

    arrays = random_spheres(n, seed=3, spread=10.0, device="cpu")
    scene = Scene()
    for i in range(n):
        s = Sphere()
        s.center = Vector3(*map(float, arrays.center[i]))
        s.radius = float(arrays.radius[i])
        m = Material()
        m.albedo = Vector3(*map(float, arrays.albedo[i]))
        m.metallic = float(arrays.metallic[i])
        m.roughness = float(arrays.roughness[i])
        m.emission = Vector3(*map(float, arrays.emission[i]))
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


@pytest.mark.parametrize("engine", ["pallas", "cluster"])
def test_port_spans_are_flat_siblings_and_uploads_repeat(dev, engine):
    """Under a profiler, each RayTracer batch on the card runs the port's
    spans camera, (order on a camera move,) prepare and launch, in that
    order, none inside another, all with the batch's number; the first
    batch of a pose counts 9 uploads (make_camera's 7, basis's 2), a batch
    that repeats it none, and the first after a move 9 again, as on the
    CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_rt_torch.api import RayTracer, Vector3
    from tpu_rt_torch.app import SceneManager
    from tpu_rt_torch.utils import profiling

    rt = RayTracer(seed=5, device=dev)
    rt.set_scene(SceneManager.create_interactive_scene()
                 if engine == "pallas" else _api_field(1000))
    uploads = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for moved in (False, False, False, True):
            if moved:
                rt.move_camera(Vector3(0.25, 0.0, 0.0))
            before = profiling.counts()["uploads"]
            rt.render_device(256, 128, 2, 3)
            uploads.append(profiling.counts()["uploads"] - before)
        torch.cuda.synchronize(dev)
    assert rt._last_engine == engine and uploads == [9, 0, 0, 9]
    spans = sorted(((ev.start_ns(), ev.end_ns(), ev.name(),
                     ev.kwinputs().get("batch"))
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == DeviceType.CPU
                    and ev.name().startswith(profiling.SPAN_PREFIX)))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    phases = [(name[len(profiling.SPAN_PREFIX):], batch)
              for _, _, name, batch in spans]
    first = ["camera", "order", "prepare", "launch"] if engine == "cluster" \
        else ["camera", "prepare", "launch"]
    assert phases == ([(p, 0) for p in first]
                      + [(p, b) for b in (1, 2)
                         for p in ("camera", "prepare", "launch")]
                      + [(p, 3) for p in first])


def test_launches_counter_counts_each_launch_of_the_wrappers(dev, scene):
    """The counter ``launches`` adds K1's one launch a call, and K2's
    chunks with their mean passes: a 1080p terrain of 10,082 triangles
    with NEE at 256 spp runs 32 chunks of 8 samples, so 64 launches, and
    ``render_cluster.launches`` adds the 32 chunks; under a profiler they
    are traced counts."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_rt_torch.utils import profiling

    cam = tpu_rt_torch.make_camera(aspect=640 / 480, device=dev)
    before = profiling.counts().get("launches", 0)
    render_megakernel(scene, cam, 3, width=640, height=480, spp=2,
                      max_depth=3, n_active=N_ACTIVE)
    assert profiling.counts()["launches"] == before + 1
    spheres, mesh = terrain_mesh(n=72, seed=1, device=dev)
    cam = tpu_rt_torch.make_camera(aspect=1920 / 1080, device=dev,
                                   **TERRAIN_POSE)
    chunks = render_cluster.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        render_cluster(spheres, cam, 7, width=1920, height=1080, spp=256,
                       max_depth=4, mesh=mesh, nee=True)
        torch.cuda.synchronize(dev)
    assert render_cluster.launches - chunks == 32
    assert profiling.counts()["launches"] == before + 1 + 64
    assert profiling.counts(traced=True)["launches"] == 64


def _fresh_render(rt, scene, batch, shape, **kw):
    """RayTracer batch ``batch`` as a fresh ``frame.render`` on the card
    draws it: a new camera with the tracer's camera values and the scene
    snapshotted anew, every kernel input built inside the call."""
    from tpu_rt_torch.api import Camera
    from tpu_rt_torch.api.compat import batch_seed
    from tpu_rt_torch.render import frame

    width, height, spp, depth = shape
    c = Camera()
    for name in ("position", "target", "up", "fov"):
        setattr(c, name, getattr(rt.camera, name))
    c.aspect_ratio = width / height
    arrays = scene.to_arrays(device=rt.device)
    return frame.render(
        arrays, c.to_params(rt.device), batch_seed(rt._seed_base, batch),
        width=width, height=height, spp=spp, max_depth=depth,
        n_active=frame.quantize_count(len(scene.spheres), arrays.capacity),
        nee=rt._nee, enable_dof=False, **kw)


@pytest.mark.parametrize("case", ["pallas", "pallas_nee", "cluster"])
def test_raytracer_inputs_built_once_equal_the_per_call_path(dev, case):
    """A RayTracer's batches on the card, whose kernel inputs are built
    once per scene and pose, equal fresh per-call renders bit for bit,
    image and segments, across a camera move and a repeated pose."""
    from tpu_rt_torch.api import RayTracer, Vector3
    from tpu_rt_torch.app import SceneManager
    from tpu_rt_torch.api.compat import batch_seed
    from tpu_rt_torch.render import frame

    engine = case.split("_")[0]
    scene = (SceneManager.create_interactive_scene() if engine == "pallas"
             else _api_field(1000))
    rt = RayTracer(seed=11, nee=case.endswith("nee"), device=dev)
    rt.set_scene(scene)
    shape = (640, 480, 8, 4)
    for moved in (False, False, True, False):
        if moved:
            rt.move_camera(Vector3(0.3, -0.1, 0.2))
        batch = rt._frame
        img = rt.render_device(*shape)
        assert rt._last_engine == engine
        ref, ref_segs = _fresh_render(rt, scene, batch, shape,
                                      with_stats=True)
        cam, packed = rt._pose
        cached, segs = frame.render(
            rt._scene_arrays, cam, batch_seed(rt._seed_base, batch),
            width=640, height=480, spp=8, max_depth=4, n_active=rt._n_active,
            nee=rt._nee, enable_dof=False, lights=rt._lights,
            tables=rt._tables, packed_camera=packed, with_stats=True)
        torch.cuda.synchronize(dev)
        assert torch.equal(img, ref) and torch.equal(cached, ref)
        assert int(segs) == int(ref_segs)


def test_render_device_does_not_wait_for_the_running_batch(dev):
    """With a long K1 batch (1080p, 256 spp) queued and no pull, the next
    batch of the same pose returns to the host in under 1 ms (median of
    5), and the stream is still busy after it: nothing in the call waited
    for the card."""
    from tpu_rt_torch.api import RayTracer
    from tpu_rt_torch.app import SceneManager

    rt = RayTracer(seed=3, device=dev)
    rt.set_scene(SceneManager.create_interactive_scene())
    shape = (1920, 1080, 256, 4)
    rt.render_device(*shape)  # the pose's inputs, the kernels' build
    stream = torch.cuda.current_stream(dev)
    times = []
    for _ in range(5):
        torch.cuda.synchronize(dev)
        rt.render_device(*shape)
        t0 = time.perf_counter()
        rt.render_device(*shape)
        times.append(time.perf_counter() - t0)
        assert not stream.query()
    torch.cuda.synchronize(dev)
    assert sorted(times)[2] < 1e-3, times
