"""The port's threefry streams (tpu_rt_torch/core/rng.py) against
jax.random on the CPU: bits, split, fold_in and uniform bit for bit over
several keys and shapes; normal within 4 ulps (XLA's erf_inv rounds its
log1p and its multiply-adds its own way); the unit-ball sampler within a
stated bound (XLA:CPU's rsqrt and cbrt shortcuts)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tpu_rt.core import rng as j_rng

from tpu_rt_torch.core import rng

# six xdist workers share the CPU: one intra-op thread each
torch.set_num_threads(1)
CPU = torch.device("cpu")
SEEDS = [0, 5, 12345, 2**31 - 2]
SHAPES = [(300,), (150, 2), (12, 16, 2)]


def _data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ulp distance of two same-sign-or-small f32 arrays."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_jax(seed):
    assert np.array_equal(rng.key(seed, device=CPU).numpy(),
                          _data(jax.random.key(seed)))


@pytest.mark.parametrize("shape", SHAPES, ids=["R", "R_2", "H_W_2"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal(seed, shape):
    jk, tk = jax.random.key(seed), rng.key(seed, device=CPU)
    jb = np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32))
    assert np.array_equal(rng.bits(tk, shape).numpy(), jb.astype(np.int64))
    ju = np.asarray(jax.random.uniform(jk, shape, dtype=jnp.float32))
    tu = rng.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32 and np.array_equal(tu, ju)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_bit_equal(seed):
    jk, tk = jax.random.key(seed), rng.key(seed, device=CPU)
    for n in (2, 5):
        assert np.array_equal(rng.split(tk, n).numpy(),
                              _data(jax.random.split(jk, n)))
    for d in (0, 7, 101, 102, 0x7FFFABCD, 2**32 - 1):
        assert np.array_equal(rng.fold_in(tk, d).numpy(),
                              _data(jax.random.fold_in(jk, d)))
    # a batch of keys, and a tensor of data, as the lax engine folds them
    ks = rng.fold_in(tk, torch.arange(4))
    assert ks.shape == (4, 2)
    for s in range(4):
        jks = jax.random.fold_in(jk, s)
        assert np.array_equal(ks[s].numpy(), _data(jks))
        assert np.array_equal(rng.split(ks, 5)[s].numpy(),
                              _data(jax.random.split(jks, 5)))
        ju = np.asarray(jax.random.uniform(jks, (6, 2)))
        assert np.array_equal(rng.uniform(ks, (6, 2))[s].numpy(), ju)


def test_normal_within_4_ulps():
    """Measured over 200,000 draws: at most 3 ulps, 99.03% equal."""
    jn = np.asarray(jax.random.normal(jax.random.key(3), (200_000,)))
    tn = rng.normal(rng.key(3, device=CPU), (200_000,)).numpy()
    u = _ulps(jn, tn)
    assert u.max() <= 4, u.max()
    assert (u == 0).mean() >= 0.98, (u == 0).mean()
    assert np.isfinite(tn).all()


def test_unit_ball_within_bound():
    """Measured: at most 2.4e-7 apart (XLA:CPU rounds the normalizing
    rsqrt and the cube root its own way); every sample in the ball."""
    k = jax.random.key(9)
    jb = np.asarray(jax.jit(lambda kk: j_rng.unit_ball(kk, (20_000,)))(k))
    tb = rng.unit_ball(rng.key(9, device=CPU), (20_000,)).numpy()
    assert tb.shape == (20_000, 3)
    assert np.abs(jb - tb).max() <= 1e-6
    assert (np.linalg.norm(tb, axis=-1) <= 1.0 + 1e-6).all()


def test_hemisphere_and_uniform_samplers():
    k = rng.key(4, device=CPU)
    n = torch.tensor([[0.0, 1.0, 0.0]]).expand(1000, 3)
    h = rng.hemisphere(k, n)
    assert (h[:, 1] >= 0).all()
    jh = np.asarray(j_rng.uniform(jax.random.key(4), (1000,)))
    assert np.array_equal(rng.uniform(k, (1000,)).numpy(), jh)
