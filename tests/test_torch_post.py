"""The denoiser bank in the port (tpu_rt_torch/ops/post.py, render/display.py,
app/denoiser.py) against the JAX package's, on the CPU.

One parametrised case per filter on a 24x32 image: gaussian and median bit
for bit (the uint8 roundtrip, integer sums), bilateral, the joint bilateral
and nlmeans within 1e-5 (their weights go through exp, whose last bits
differ between XLA and torch), nlmeans at its defaults once; the display
stack with two denoisers at grid_scale 1 and 2 in uint8; the quad's
unpacking; and the Denoiser's API. The JAX filters run in one module-scoped
compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from tpu_rt.app.denoiser import Denoiser as JDenoiser
from tpu_rt.ops import post as jpost
from tpu_rt.render import display as j_display

from tpu_rt_torch.app.denoiser import Denoiser
from tpu_rt_torch.core.types import T_MAX
from tpu_rt_torch.ops import post
from tpu_rt_torch.render import display

torch.set_num_threads(1)
H, W = 24, 32
CPU = torch.device("cpu")


def _inputs():
    rng = np.random.default_rng(17)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    nrm = rng.normal(size=(H, W, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dep = rng.uniform(1, 8, (H, W)).astype(np.float32)
    # a block of misses: zero normal, depth T_MAX
    nrm[:4, :6] = 0.0
    dep[:4, :6] = T_MAX
    return img, nrm, dep


IMG, NRM, DEP = _inputs()

PORT = {
    "gaussian": lambda i, n, d: post.gaussian_blur(i),
    "median": lambda i, n, d: post.median_blur(i),
    "bilateral": lambda i, n, d: post.bilateral_filter(i),
    "joint": lambda i, n, d: post.joint_bilateral(i, n, d),
    "nlmeans_3_5": lambda i, n, d: post.nlmeans(i, 10.0, 3, 5),
}
# gaussian and median sum and sort integers: bit for bit
EXACT = {"gaussian", "median"}


@pytest.fixture(scope="module")
def jax_filters():
    fn = jax.jit(lambda i, n, d: {
        "gaussian": jpost.gaussian_blur(i),
        "median": jpost.median_blur(i),
        "bilateral": jpost.bilateral_filter(i),
        "joint": jpost.joint_bilateral(i, n, d),
        "nlmeans_3_5": jpost.nlmeans(i, 10.0, 3, 5),
    })
    out = fn(jnp.asarray(IMG), jnp.asarray(NRM), jnp.asarray(DEP))
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(PORT))
def test_filter_matches_jax(jax_filters, name):
    ours = PORT[name](torch.from_numpy(IMG), torch.from_numpy(NRM),
                      torch.from_numpy(DEP)).numpy()
    ref = jax_filters[name]
    assert ours.shape == ref.shape == (H, W, 3) and ours.dtype == np.float32
    if name in EXACT:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert not np.array_equal(ours, IMG)


def test_nlmeans_defaults_match_jax():
    ref = np.asarray(jpost.nlmeans(jnp.asarray(IMG)))
    ours = post.nlmeans(torch.from_numpy(IMG)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_pads_longer_than_the_image():
    """jnp.pad reflects past the edge (period 2(n-1)); so does the port,
    where torch's own reflect padding would refuse."""
    x = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    for mode in ("reflect", "edge"):
        ref = np.asarray(jnp.pad(jnp.asarray(x), ((7, 5), (4, 9), (0, 0)),
                                 mode=mode))
        ours = post._pad_hw(torch.from_numpy(x), (7, 5), (4, 9), mode)
        np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.fixture(scope="module")
def acc():
    return np.random.default_rng(3).uniform(0, 1.5, (H, W, 3)).astype(
        np.float32)


@pytest.mark.parametrize("grid_scale", [1, 2])
def test_display_stack_denoisers_match_jax(acc, grid_scale):
    methods = ("gaussian", "median")
    ref = np.asarray(j_display.display_stack(
        jnp.asarray(acc), 1.5, methods=methods, as_uint8=True,
        grid_scale=grid_scale))
    ours = display.display_stack(torch.from_numpy(acc), 1.5,
                                 methods=methods, as_uint8=True,
                                 grid_scale=grid_scale).numpy()
    rows = 3 if grid_scale > 1 else 4
    assert ours.shape == ref.shape == (rows, H, W, 3)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


def test_unpack_grid_on_the_quad(acc):
    methods = ("gaussian", "median", "bilateral")
    stack = display.display_stack(torch.from_numpy(acc), 1.5,
                                  methods=methods, grid_scale=2)
    assert stack.shape == (3, H, W, 3)
    small = stack[display.DISPLAY].reshape(H // 2, 2, W // 2, 2, 3).mean(
        dim=(1, 3))
    tiles = display.unpack_grid(stack[2], methods, 2)
    tiles_np = display.unpack_grid(stack[2].numpy(), methods, 2)
    tiles_jax = j_display.unpack_grid(stack[2].numpy(), methods, 2)
    for m in methods:
        want = display._apply_method(m, small)
        assert tiles[m].shape == (H // 2, W // 2, 3)
        assert torch.equal(tiles[m], want)
        np.testing.assert_array_equal(tiles_np[m], want.numpy())
        np.testing.assert_array_equal(tiles_jax[m], want.numpy())
    # the fourth tile of three methods stays zero
    assert not stack[2, H // 2:, W // 2:].any()


@pytest.mark.parametrize("grid_scale", [1, 2])
def test_joint_in_methods_raises(acc, grid_scale):
    with pytest.raises(ValueError, match="joint"):
        display.display_stack(torch.from_numpy(acc), 1.5, methods=("joint",),
                              grid_scale=grid_scale)
    with pytest.raises(ValueError, match="at most 4"):
        display.display_stack(torch.from_numpy(acc), 1.5,
                              methods=("gaussian",) * 5, grid_scale=2)


def test_denoiser_api():
    d = Denoiser(device=CPU)
    assert d.available_methods == JDenoiser().available_methods
    assert d.backend == "torch"
    assert Denoiser().device == torch.device("cuda")  # the card by default
    img = torch.from_numpy(IMG)
    for m, fn in (("gaussian", post.gaussian_blur),
                  ("median", post.median_blur),
                  ("bilateral", post.bilateral_filter)):
        out = d.denoise(IMG, m)
        assert isinstance(out, np.ndarray) and out.dtype == np.float32
        np.testing.assert_array_equal(out, fn(img).numpy())
    np.testing.assert_array_equal(
        d.denoise(img, "nlmeans", template_window_size=3,
                  search_window_size=5),
        post.nlmeans(img, 10.0, 3, 5).numpy())
    with pytest.raises(ValueError, match="Unknown"):
        d.denoise(IMG, "wavelet")
    with pytest.raises(ValueError, match="aovs"):
        d.denoise(IMG, "joint")
    aovs = {"normal": NRM, "depth": DEP}
    np.testing.assert_array_equal(
        d.denoise(IMG, "joint", aovs=aovs),
        post.joint_bilateral(img, torch.from_numpy(NRM),
                             torch.from_numpy(DEP)).numpy())
