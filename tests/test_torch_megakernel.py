"""The megakernel's plain PyTorch version against the JAX package.

The counter hash bit for bit; renders stream for stream against
``render_pallas(..., interpret=True)`` (the JAX kernel's interpret mode draws
from the same hash); the C++ depth-1 golden. The CUDA kernel itself runs
only on a GPU (tests/test_torch_gpu.py, chip_smoke.py); here the checks
that need no compiler: its constants agree with the Python side, and the
wrapper on CPU tensors takes the plain version without counting a launch.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.ops.pallas_megakernel import _hash_uniform as j_hash_uniform
from tpu_rt.ops.pallas_megakernel import render_pallas

import tpu_rt_torch
from tpu_rt_torch.kernels import build
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.utils.convert import camera_from_numpy, scene_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
N_ACTIVE = 12  # quantize_count(9, 16): rows 9-11 are padding


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def both(width, height):
    """The demo scene and a camera for this aspect, in both packages."""
    js = tpu_rt.demo_scene()
    jc = tpu_rt.make_camera(aspect=width / height)
    return (js, jc, scene_from_numpy(to_np_fields(js), CPU),
            camera_from_numpy(to_np_fields(jc), CPU))


def test_hash_uniform_bit_identical():
    rng = np.random.default_rng(42)
    pix = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    seeds = np.concatenate([
        rng.integers(-2**31, 2**31, 4000, dtype=np.int64),
        2**31 - 1 - np.arange(48), -2**31 + np.arange(48)]).astype(np.int32)
    for salt in (1, 2, 3, 12, 15, 9001, 9002):
        ref = np.asarray(j_hash_uniform(jnp.asarray(pix), jnp.asarray(seeds),
                                        salt))
        ours = mk._hash_uniform(torch.from_numpy(pix),
                                torch.from_numpy(seeds), salt).numpy()
        np.testing.assert_array_equal(ours, ref)
        assert ours.min() >= 0.0 and ours.max() < 1.0


def test_plain_matches_render_pallas_depth1_two_tiles():
    js, jc, ts, tc = both(128, 64)
    ref = np.asarray(render_pallas(js, jc, 3, width=128, height=64, spp=1,
                                   max_depth=1, jitter=False, interpret=True,
                                   n_active=N_ACTIVE))
    ours = mk.render_megakernel_reference(
        ts, tc, 3, width=128, height=64, spp=1, max_depth=1, jitter=False,
        n_active=N_ACTIVE).numpy()
    assert ours.shape == (64, 128, 3)
    assert np.abs(ours - ref).max() <= 1e-6


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
def test_plain_matches_render_pallas_ragged_full_depth(seed):
    """100x50 leaves a ragged second tile; spp 2 and depth 4 reach the
    Russian-roulette bounce. The slack is only for branch flips from
    transcendental ulps between XLA:CPU and torch."""
    js, jc, ts, tc = both(100, 50)
    ref, ref_segs = render_pallas(js, jc, seed, width=100, height=50, spp=2,
                                  max_depth=4, interpret=True,
                                  n_active=N_ACTIVE, with_stats=True)
    ours, segs = mk.render_megakernel_reference(
        ts, tc, seed, width=100, height=50, spp=2, max_depth=4,
        n_active=N_ACTIVE, with_stats=True)
    d = np.abs(ours.numpy() - np.asarray(ref))
    assert float((d <= 1e-5).mean()) >= 0.999
    assert float(d.mean()) <= 1e-4
    assert abs(int(segs) - int(ref_segs)) <= 1e-3 * int(ref_segs)


def test_plain_matches_cpp_golden():
    gold = np.load(os.path.join(GOLDENS, "ref_depth1_160x120.npy"))
    scene = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=160 / 120, device=CPU)
    ours = mk.render_megakernel_reference(
        scene, cam, 0, width=160, height=120, spp=1, max_depth=1,
        jitter=False, n_active=N_ACTIVE).numpy()
    assert np.abs(ours - gold).max() <= 1e-6


def test_wrapper_on_cpu_is_the_plain_version():
    scene = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    kw = dict(width=64, height=32, spp=2, max_depth=4, n_active=N_ACTIVE,
              with_stats=True)
    before = mk.render_megakernel.launches
    a, sa = mk.render_megakernel(scene, cam, 11, **kw)
    b, sb = mk.render_megakernel_reference(scene, cam, 11, **kw)
    assert mk.render_megakernel.launches == before
    assert torch.equal(a, b) and int(sa) == int(sb)


@pytest.mark.parametrize("kw, exc", [
    # bands that leave the frame's 16 rows (bands raised until they were
    # ported; tests/test_torch_adaptive.py renders them)
    (dict(rows=17), ValueError),
    (dict(row_offset=8), ValueError),
    (dict(n_active=17), ValueError),
    (dict(spp=0), ValueError),
    (dict(rows=0), ValueError),
    (dict(rows=8, row_offset=-1), ValueError),
    (dict(tile_mask=np.ones(2, np.int32)), ValueError),  # the frame has 1
], ids=["rows_past_frame", "offset_past_frame", "n_active", "spp",
        "rows_0", "offset_negative", "mask_length"])
def test_wrapper_rejects(kw, exc):
    scene = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(device=CPU)
    args = dict(width=32, height=16, spp=1, max_depth=1)
    args.update(kw)
    with pytest.raises(exc):
        mk.render_megakernel(scene, cam, 0, **args)


def test_wrapper_rejects_other_devices():
    scene = tpu_rt_torch.demo_scene(device="meta")
    cam = tpu_rt_torch.make_camera(device="meta")
    with pytest.raises(ValueError):
        mk.render_megakernel(scene, cam, 0, width=8, height=8, spp=1,
                             max_depth=1)


def test_cuda_source_constants_match_python():
    """The kernel cannot run here; its tiling, RR start, table size and
    hash multipliers must be the ones the plain version uses; the build
    contracts no FMA, so products and sums round as in the plain version.
    """
    csrc = os.path.join(os.path.dirname(mk.__file__), os.pardir, "csrc")
    # the kernel and the header of helpers it shares with the cluster kernel
    src = "".join(open(os.path.join(csrc, name)).read()
                  for name in ("megakernel.cu", "path_common.cuh"))
    assert '#include "path_common.cuh"' in src

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kTile") == mk.TILE
    assert const("kRRStart") == mk.RR_START
    assert const("kMaxSpheres") == mk.MAX_SPHERES
    for c in (mk._C_SEED, mk._C_MIX1, mk._C_MIX2, 40503, 7919):
        assert f"{c}u" in src, c
    for c, signed in ((mk._C_SEED, -1640531527), (mk._C_MIX1, -2048144789),
                      (mk._C_MIX2, -1028477387)):
        assert c - (1 << 32) == signed
    assert not any("fast_math" in f or "fast-math" in f
                   for f in build.NVCC_FLAGS)
    assert "--fmad=false" in build.NVCC_FLAGS
