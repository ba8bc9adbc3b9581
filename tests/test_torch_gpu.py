"""tpu_rt_torch on an NVIDIA GPU: the CUDA megakernel against its plain
PyTorch version at the main path's shapes, and its RMSE of means against
the JAX package's lax-v2 golden.

Marked ``cuda``; each test skips when ``torch.cuda.is_available()`` is
False. Imports no jax, so it runs on a machine with torch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.ops.megakernel import (
    render_megakernel, render_megakernel_reference)

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
    d = (a - b).abs()
    # nvcc contracts multiply-adds into FMAs, so a few threshold
    # decisions (RR, silhouettes) may flip against the plain version
    assert float((d <= 1e-4).float().mean()) >= 0.99
    assert float(d.mean()) <= 1e-3
    assert abs(float(a.mean() - b.mean())) <= 1e-3
    assert abs(int(seg_a) - int(seg_b)) <= 0.005 * int(seg_b)


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
    d = (a - b).abs()
    assert float((d <= 1e-4).float().mean()) >= 0.99
    assert float(d.mean()) <= 1e-3
    assert abs(int(seg_a) - int(seg_b)) <= 0.005 * int(seg_b)


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
