"""The port's roofline (tpu_rt_torch/utils/roofline.py) against the JAX
package's.

K3's plain version against ``tpu_rt/utils/roofline.py:_fma_kernel`` under
``pl.pallas_call(interpret=True)`` (as tests/test_roofline.py runs it), the
CUDA source's constants against the Python side, the operation model and
bounds against hand counts, and the report's keys with stubbed rates. The
CUDA kernel itself and the measured rate run on a GPU only
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import os
import re
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from tpu_rt.utils.roofline import _BLOCK, _CARRIES, _fma_kernel

from tpu_rt_torch.utils import roofline as rl

torch.set_num_threads(1)
CSRC = os.path.join(os.path.dirname(__file__), "..", "tpu_rt_torch", "csrc")


@pytest.fixture(scope="module")
def block():
    return np.random.default_rng(11).uniform(0.25, 1.0, _BLOCK).astype(
        np.float32)


@pytest.mark.parametrize("depth", [8, 64])
def test_plain_matches_jax_kernel(block, depth):
    ref = np.asarray(pl.pallas_call(
        partial(_fma_kernel, depth=depth, carries=_CARRIES),
        out_shape=jax.ShapeDtypeStruct(_BLOCK, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(block)))
    x = torch.from_numpy(block)
    ours = rl.fma_chains_reference(x, depth).numpy()
    # the JAX kernel rounds the product and the sum apart, the plain
    # version (and K3) once: a relative gap of a few ulps per step
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    before = rl.fma_chains.launches
    assert torch.equal(rl.fma_chains(x, depth), torch.from_numpy(ours))
    assert rl.fma_chains.launches == before  # a CPU tensor runs the plain


def test_plain_depths_differ_and_grow(block):
    x = torch.from_numpy(block)
    d8, d64 = (rl.fma_chains_reference(x, d) for d in (8, 64))
    assert not torch.equal(d8, d64)  # the loop is not folded
    assert bool((d64 > d8).all()) and bool((d8 > 32 * x).all())


def test_plain_is_one_rounding_per_step():
    """Each step is fmaf: the float64 product and sum are exact for x >= 0,
    rounded once; seeds are a + f32(0.01 c)."""
    a = np.float32(0.731)
    v = [np.float32(a + np.float32(0.01 * c)) for c in range(rl.CARRIES)]
    for _ in range(5):
        v = [np.float32(np.float64(u) * np.float64(rl.FMA_MUL)
                        + np.float64(a)) for u in v]
    o = v[0]
    for u in v[1:]:
        o = np.float32(o + u)
    got = rl.fma_chains_reference(torch.tensor([a]), 5)
    assert got.dtype == torch.float32 and float(got[0]) == float(o)
    assert rl.FMA_MUL == float(np.float32(1.0000001))


def test_cuda_source_constants():
    src = open(os.path.join(CSRC, "fma.cu")).read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src)[1]

    assert int(const("kCarries")) == rl.CARRIES == _CARRIES
    assert int(const("kBlock")) == rl.FMA_BLOCK
    assert float(const("kMul").rstrip("f")) == pytest.approx(1.0000001)
    assert "__fmaf_rn(v[c], kMul, a)" in src
    assert "a + (float)(0.01 * c)" in src


def test_fma_chains_rejects():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        rl.fma_chains(x.to("meta"), 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.measure_fma_ops(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.card_fp32("cpu")


def test_op_model_hand_counts():
    # 640x480/8spp: 2.5 M rays, 4.3 M segments over 12 swept rows
    n_pix, spp, segs = 640 * 480, 8, 4_341_093
    rays = n_pix * spp
    want = (segs * 12 * 24 + (segs - rays) * 62 + rays * 33 + n_pix * 15)
    assert rl.megakernel_op_model(segs, n_pix, spp, 12) == want
    # a mesh adds 53 per triangle per segment; the flags add their ops
    flags = dict(enable_refraction=True, enable_dof=True, stratify=True)
    want_tri = (segs * (4 * 24 + 12 * 53) + (segs - rays) * (62 + 36)
                + rays * (33 + 46 + 8) + n_pix * 15)
    assert rl.megakernel_op_model(segs, n_pix, spp, 4, n_tris=12,
                                  flags=flags) == want_tri
    # NEE: half the count is shadow segments at 120 each
    shadow = segs // 2
    bounces = segs - shadow
    assert bounces < rays  # so no bounce before the last is counted shaded
    want_nee = bounces * 12 * 24 + shadow * 120 + rays * 33 + n_pix * 15
    assert rl.megakernel_op_model(segs, n_pix, spp, 12,
                                  flags={"nee": True}) == want_nee
    # fewer segments than rays: no shading counted below zero
    assert rl.path_ops(10, 4, 8, 24) == 10 * 24 + 32 * 33 + 4 * 15


def test_bound_hand_counts():
    ms, by = rl.bound_ms(33.5e9, 1e6, 33.5e12)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = rl.bound_ms(1e3, 3.35e9, 33.5e12)
    assert by == "bytes" and ms == pytest.approx(1.0)
    assert rl.megakernel_bytes(12, 4096) == (12 * 16 + 19) * 4 + 4096 * 12 + 4
    assert rl.megakernel_bytes(4, 4097, 12) == ((4 * 16 + 19) * 4 + 12 * 84
                                                + 4097 * 12 + 8)


def test_report_keys_and_share():
    r = rl.roofline_report(0.0015, 640, 480, 8, 4, 12, segments=4_341_093,
                           fma_ops=30e12, theoretical_ops=33.5e12)
    assert set(r) == {
        "model_vector_ops_per_frame_g", "achieved_gops",
        "fp32_theoretical_gops", "fma_slope_measured_gops",
        "utilization_vs_theoretical_pct", "achieved_over_fma_bracket",
        "arithmetic_intensity_ops_per_hbm_byte", "bound", "bound_ms",
        "bound_ms_measured", "note"}
    ops = rl.megakernel_op_model(4_341_093, 640 * 480, 8, 12)
    assert r["model_vector_ops_per_frame_g"] == pytest.approx(ops / 1e9)
    assert r["achieved_gops"] == pytest.approx(ops / 0.0015 / 1e9)
    assert 0 < r["utilization_vs_theoretical_pct"] < 100
    assert r["achieved_over_fma_bracket"] == pytest.approx(ops / 0.0015
                                                           / 30e12)
    assert r["bound"].startswith("compute")
    # the bound at the theoretical rate; the measured rate's is longer
    assert r["bound_ms"] == pytest.approx(ops / 33.5e12 * 1e3)
    assert r["bound_ms_measured"] == pytest.approx(ops / 30e12 * 1e3)
    assert r["fp32_theoretical_gops"] == pytest.approx(33500.0)
    for tpu_figure in ("1024", "v5e", "VPU", "1.5 GHz", "6.1"):
        assert tpu_figure not in r["note"]
    with pytest.raises(ValueError, match="segments"):
        rl.roofline_report(0.0015, 64, 48, 1, 1, 12, segments=64 * 48 + 1,
                           fma_ops=1.0, theoretical_ops=1.0)


def test_report_measures_when_not_given(monkeypatch):
    monkeypatch.setattr(rl, "measure_fma_ops", lambda **k: rl.FmaSlope(
        20e12, 1024, (8, 64), (1.0, 2.0), 20))
    monkeypatch.setattr(rl, "theoretical_fp32_ops", lambda device: 25e12)
    r = rl.roofline_report(0.001, 64, 48, 2, 4, 12, segments=20_000)
    assert r["fma_slope_measured_gops"] == pytest.approx(20000.0)
    assert r["fp32_theoretical_gops"] == pytest.approx(25000.0)
