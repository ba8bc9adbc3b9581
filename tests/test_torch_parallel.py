"""The port's parallel layer on the CPU, against the JAX package's.

``tpu_rt_torch.parallel`` on a virtual mesh of eight ``torch.device("cpu")``
entries (the JAX tests' eight virtual CPU devices): ``make_mesh`` shapes
and errors as ``tpu_rt.parallel.make_mesh``'s; per-shard keys and K1/K2
seeds word for word ``jax.random``'s; the lax engine against
``tpu_rt.parallel.render_sharded`` (a (2, 4) mesh at depth 1 exactly, a
(4, 2) mesh with NEE, stratify, DOF, a triangle mesh and the LBVH at
depth 2 within 1e-4, the known XLA:CPU gap) and, on the other shapes,
against the composition of its own bands; ``engine="pallas"`` against the
JAX call of ``tests/test_parallel.py``'s 8-device interpret-mode test
within 1e-6; both kernel engines bit for bit the composition of the plain
bands at JAX's seeds; the ValueErrors; the multi-host layout, a simulated
2-host pod rendering bit for bit the single-process mesh.

Three JAX compilations of ``render_sharded`` (two lax, one pallas)."""

import jax
import numpy as np
import pytest
import torch

from tpu_rt.core import types as j_types
from tpu_rt.ops.triangle import quad as j_quad
from tpu_rt.parallel import make_mesh as j_make_mesh
from tpu_rt.parallel import render_sharded as j_render_sharded

from tpu_rt_torch.core import rng
from tpu_rt_torch.core import vecmath as vm
from tpu_rt_torch.core.scenes import random_spheres
from tpu_rt_torch.ops import cluster as k2
from tpu_rt_torch.ops import megakernel as k1
from tpu_rt_torch.parallel import (
    dcn_bytes_per_displayed_frame, group_devices_by_host, make_mesh,
    make_multihost_mesh, render_sharded, sample_groups_are_host_local)
from tpu_rt_torch.parallel.mesh import (
    MeshDevice, ShardedImage, mesh_devices, shard_keys, shard_seed)
from tpu_rt_torch.render.frame import CP_SHIFT_FOLD, lax_band_sum
from tpu_rt_torch.utils.convert import (
    camera_from_numpy, mesh_from_numpy, scene_from_numpy)

# six xdist workers share the CPU: one intra-op thread each
torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 11
KEY = jax.random.key(SEED)  # tests/test_parallel.py's


def port(nt):
    """A tpu_rt NamedTuple's fields as numpy, for the converters."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def key():
    return rng.key(SEED, device=CPU)


def cpu_entries(n=8):
    return mesh_devices([CPU] * n)


@pytest.fixture(scope="module")
def demo():
    """The demo scene and tests/test_parallel.py's 32x16 camera, in both
    packages."""
    js, jc = j_types.demo_scene(), j_types.make_camera(aspect=32 / 16)
    return js, jc, scene_from_numpy(port(js), CPU), camera_from_numpy(
        port(jc), CPU)


# ---- the mesh ---------------------------------------------------------------

def test_mesh_factorizations_match_jax(cpu_devices):
    cases = [dict(), dict(n_tile=2, n_sample=4), dict(n_sample=8),
             dict(n_tile=4)]
    for kw in cases:
        ours = make_mesh(devices=[CPU] * 8, **kw)
        ref = j_make_mesh(devices=cpu_devices, **kw)
        assert ours.shape == dict(ref.shape)
        assert ours.axis_names == tuple(ref.axis_names) == ("tile", "sample")
        assert ours.devices.shape == ref.devices.shape
    assert make_mesh(devices=[CPU] * 8).shape == {"tile": 8, "sample": 1}
    for kw in (dict(n_tile=3), dict(n_sample=3), dict(n_tile=2, n_sample=2)):
        with pytest.raises(ValueError):
            j_make_mesh(devices=cpu_devices, **kw)
        with pytest.raises(ValueError):
            make_mesh(devices=[CPU] * 8, **kw)


def test_mesh_entries_keep_their_order_and_identity():
    entries = cpu_entries()
    mesh = make_mesh(n_tile=4, n_sample=2, devices=entries)
    assert [d for d in mesh.devices.flat] == entries
    assert len({id(d) for d in mesh.devices.flat}) == 8
    assert all(d.device == CPU and d.process == 0 for d in entries)
    assert mesh.processes == {0}


def test_make_mesh_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (make_mesh, group_devices_by_host, make_multihost_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


# ---- keys and seeds ---------------------------------------------------------

def test_shard_keys_and_seeds_match_jax():
    keys = shard_keys(key(), 4, 2)
    assert keys.shape == (4, 2, 2)
    for ti in range(4):
        for si in range(2):
            dk = jax.random.fold_in(jax.random.fold_in(KEY, ti), si + 1)
            words = np.asarray(jax.random.key_data(dk))
            np.testing.assert_array_equal(keys[ti, si].numpy(), words)
            seed = words.ravel()[-1].astype(np.int32)
            assert shard_seed(keys[ti, si]) == int(seed)
    # the second words wrap to int32 as JAX's astype does: some are negative
    seeds = [shard_seed(k) for k in keys.reshape(-1, 2)]
    assert any(s < 0 for s in seeds) and len(set(seeds)) == 8


def jax_seeds(n_tile, n_sample):
    return [[int(np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.fold_in(KEY, ti), si + 1))).ravel()[-1].astype(np.int32))
        for si in range(n_sample)] for ti in range(n_tile)]


# ---- the lax engine ---------------------------------------------------------

def test_lax_2x4_depth1_equals_jax_exactly(demo, cpu_devices):
    js, jc, ts, tc = demo
    kw = dict(width=32, height=16, spp=8, max_depth=1)
    ref = np.asarray(j_render_sharded(
        js, jc, KEY, j_make_mesh(n_tile=2, n_sample=4, devices=cpu_devices),
        **kw))
    out = render_sharded(ts, tc, key(), make_mesh(2, 4, devices=[CPU] * 8),
                         **kw)
    assert isinstance(out, ShardedImage) and out.shape == (16, 32, 3)
    img = np.asarray(out)
    np.testing.assert_array_equal(img, ref)
    assert sorted(out.bands) == [0, 1]
    assert out.shards == tuple((t, s) for t in range(2) for s in range(4))


def test_lax_4x2_every_flag_matches_jax(cpu_devices):
    """NEE, stratify, the thin lens, a triangle mesh and the LBVH in one
    call, at depth 2: within 1e-4 (XLA:CPU's arithmetic)."""
    js = j_types.demo_scene()
    jc = j_types.make_camera(aspect=2.0, aperture=0.05, focus_dist=8.0)
    jm = j_quad((-8, -0.5, -18), (8, -0.5, -18), (8, -0.5, -2),
                (-8, -0.5, -2), albedo=(0.6, 0.6, 0.2))
    kw = dict(width=32, height=16, spp=8, max_depth=2, nee=True,
              stratify=True, enable_dof=True, use_bvh=True)
    ref = np.asarray(j_render_sharded(
        js, jc, KEY, j_make_mesh(n_tile=4, n_sample=2, devices=cpu_devices),
        scene_mesh=jm, **kw))
    img = np.asarray(render_sharded(
        scene_from_numpy(port(js), CPU), camera_from_numpy(port(jc), CPU),
        key(), make_mesh(4, 2, devices=[CPU] * 8),
        scene_mesh=mesh_from_numpy(port(jm), CPU), **kw))
    assert img.shape == ref.shape == (16, 32, 3)
    assert np.abs(img - ref).max() <= 1e-4


def lax_composition(scene, cam, n_tile, n_sample, width, height, spp, **kw):
    """The lax frame put together by hand from lax_band_sum's bands."""
    keys = shard_keys(key(), n_tile, n_sample)
    rows, spp_per = height // n_tile, spp // n_sample
    bands = []
    for ti in range(n_tile):
        acc = None
        for si in range(n_sample):
            band, _ = lax_band_sum(
                scene, cam, keys[ti, si], width=width, height=height,
                spp=spp_per, rows=rows, row_offset=ti * rows,
                lattice_offset=si * spp_per,
                shift_key=rng.fold_in(rng.fold_in(key(), ti), CP_SHIFT_FOLD),
                **kw)
            acc = band if acc is None else acc + band
        bands.append(acc)
    img = torch.cat(bands) / torch.tensor(float(spp))
    return torch.clamp(vm.sqrt(torch.clamp_min(img, 0.0)), 0.0, 1.0)


@pytest.mark.parametrize("tile,sample", [(8, 1), (1, 8)])
def test_lax_other_shapes_equal_their_composition(demo, tile, sample):
    _, _, ts, tc = demo
    kw = dict(width=32, height=16, spp=8, max_depth=2)
    out = render_sharded(ts, tc, key(),
                         make_mesh(tile, sample, devices=[CPU] * 8), **kw)
    img = out.gather()
    assert img.shape == (16, 32, 3) and img.device == CPU
    assert torch.isfinite(img).all() and 0 <= img.min() and img.max() <= 1
    ref = lax_composition(ts, tc, tile, sample, max_depth=2, width=32,
                          height=16, spp=8, stratify=False)
    assert torch.equal(img, ref)
    # a stratified frame too: the shift keyed by the tile, the lattice global
    strat = render_sharded(ts, tc, key(),
                           make_mesh(tile, sample, devices=[CPU] * 8),
                           stratify=True, **kw).gather()
    assert torch.equal(strat, lax_composition(
        ts, tc, tile, sample, max_depth=2, width=32, height=16, spp=8,
        stratify=True))
    assert not torch.equal(strat, img)


# ---- the kernel engines -----------------------------------------------------

def test_pallas_matches_jax_interpreted(demo, cpu_devices):
    """tests/test_parallel.py's 8-device interpret-mode call."""
    js, jc, ts, tc = demo
    kw = dict(width=32, height=16, spp=8, max_depth=3, engine="pallas",
              n_active=9)
    ref = np.asarray(j_render_sharded(
        js, jc, KEY, j_make_mesh(n_tile=2, n_sample=4, devices=cpu_devices),
        interpret=True, **kw))
    out = render_sharded(ts, tc, key(), make_mesh(2, 4, devices=[CPU] * 8),
                         **kw)
    img = np.asarray(out)
    assert img.shape == ref.shape == (16, 32, 3)
    assert np.abs(img - ref).max() <= 1e-6
    assert out.segments > 32 * 16 * 8


def kernel_composition(render, scene, cam, n_tile, n_sample, width, height,
                       spp, **kw):
    """A kernel engine's frame put together by hand: each band at JAX's
    seed, summed in sample order, averaged, gamma'd."""
    seeds = jax_seeds(n_tile, n_sample)
    rows = height // n_tile
    bands = []
    for ti in range(n_tile):
        acc = None
        for si in range(n_sample):
            band = render(scene, cam, seeds[ti][si], width=width,
                          height=height, spp=spp // n_sample, rows=rows,
                          row_offset=ti * rows, gamma=False, **kw)
            acc = band if acc is None else acc + band
        bands.append(acc / torch.tensor(float(n_sample)))
    img = torch.cat(bands)
    return torch.clamp(vm.sqrt(torch.clamp_min(img, 0.0)), 0.0, 1.0)


def kernel_case(engine):
    """(render, scene, camera, triangle mesh, size) of each kernel engine:
    the cluster engine with 100 spheres (past the megakernel's 64) and 32
    rows a band, the megakernel with the demo scene; both with a ground
    quad and NEE, so the replicated tables and light tables are used."""
    mesh = mesh_from_numpy(port(j_quad(
        (-8, -0.5, -18), (8, -0.5, -18), (8, -0.5, -2), (-8, -0.5, -2),
        albedo=(0.6, 0.6, 0.2))), CPU)
    if engine == "cluster":
        scene = random_spheres(100, seed=1, spread=8.0, device=CPU)
        cam = camera_from_numpy(port(j_types.make_camera(
            position=(0, 4, 16), target=(0, 0, -6), aspect=1.0)), CPU)
        return k2.render_cluster, scene, cam, mesh, (64, 64)
    js = j_types.demo_scene()
    cam = camera_from_numpy(port(j_types.make_camera(aspect=2.0)), CPU)
    return k1.render_megakernel, scene_from_numpy(port(js), CPU), cam, mesh, (
        32, 16)


@pytest.mark.parametrize("engine", ["pallas", "cluster"])
def test_kernel_engines_equal_their_band_composition(engine):
    render, scene, cam, tmesh, (w, h) = kernel_case(engine)
    kw = dict(max_depth=2, nee=True, stratify=True)
    out = render_sharded(scene, cam, key(), make_mesh(2, 4, devices=[CPU] * 8),
                         width=w, height=h, spp=8, engine=engine,
                         scene_mesh=tmesh, **kw)
    ref = kernel_composition(render, scene, cam, 2, 4, w, h, 8, mesh=tmesh,
                             **kw)
    img = out.gather()
    assert img.shape == (h, w, 3)
    assert torch.equal(img, ref), int((img != ref).sum())


# ---- errors -----------------------------------------------------------------

def test_errors(demo, cpu_devices):
    js, jc, ts, tc = demo
    mesh8 = make_mesh(n_tile=8, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        j_render_sharded(js, jc, KEY, j_make_mesh(n_tile=8,
                                                  devices=cpu_devices),
                         width=32, height=12, spp=4, max_depth=2)
    with pytest.raises(ValueError, match="height 12"):
        render_sharded(ts, tc, key(), mesh8, width=32, height=12, spp=4,
                       max_depth=2)
    with pytest.raises(ValueError, match="spp 6"):
        render_sharded(ts, tc, key(), make_mesh(2, 4, devices=[CPU] * 8),
                       width=32, height=16, spp=6, max_depth=2)
    # K2's bands lie on the 32-row grid: 64 rows over 4 tiles do not
    with pytest.raises(ValueError, match="32"):
        render_sharded(ts, tc, key(), make_mesh(4, 2, devices=[CPU] * 8),
                       width=64, height=64, spp=4, engine="cluster")
    with pytest.raises(ValueError, match="engine"):
        render_sharded(ts, tc, key(), mesh8, width=32, height=16,
                       engine="megakernel")
    # a mesh of another process's entries needs a process group
    foreign = make_mesh(2, 1, devices=[MeshDevice(CPU, 0),
                                       MeshDevice(CPU, 1)])
    with pytest.raises(ValueError, match="process group"):
        render_sharded(ts, tc, key(), foreign, width=32, height=16)


# ---- the multi-host layout --------------------------------------------------

def test_simulated_pod_keeps_sample_groups_on_host_and_equals_one_host(demo):
    """tests/test_parallel.py's simulated 2-host pod: the host-major layout
    keeps every sample group inside one host and renders bit for bit the
    single-process mesh of the same shape, for every engine."""
    _, _, ts, tc = demo
    cpu = cpu_entries()
    host_of = lambda d: cpu.index(d) // 4  # noqa: E731
    pod = make_multihost_mesh(n_hosts=2, devices=cpu, sample_per_host=2)
    assert pod.shape == {"tile": 4, "sample": 2}
    assert sample_groups_are_host_local(pod, host_of=host_of)
    for t in range(4):
        assert {host_of(d) for d in pod.devices[t]} == {t // 2}
    single = make_mesh(n_tile=4, n_sample=2, devices=[CPU] * 8)
    interleaved = make_mesh(4, 2, devices=[cpu[i // 2 + 4 * (i % 2)]
                                           for i in range(8)])
    assert not sample_groups_are_host_local(interleaved, host_of=host_of)
    for engine in ("lax", "pallas"):
        kw = dict(width=32, height=16, spp=8, max_depth=2, engine=engine)
        a = np.asarray(render_sharded(ts, tc, key(), pod, **kw))
        b = np.asarray(render_sharded(ts, tc, key(), single, **kw))
        c = np.asarray(render_sharded(ts, tc, key(), interleaved, **kw))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert dcn_bytes_per_displayed_frame(1920, 1080, 2) == \
        1920 * 1080 * 3 * 4 // 2


def test_multihost_mesh_validation():
    cpu = cpu_entries()
    with pytest.raises(ValueError):
        make_multihost_mesh(n_hosts=3, devices=cpu)
    with pytest.raises(ValueError):
        make_multihost_mesh(n_hosts=2, devices=cpu, sample_per_host=3)
    # the real topology without a process group: one host, every entry
    auto = make_multihost_mesh(devices=cpu, sample_per_host=4)
    assert auto.shape == {"tile": 2, "sample": 4}
    assert [len(h) for h in group_devices_by_host(cpu)] == [8]
    assert sample_groups_are_host_local(auto)
    mixed = [MeshDevice(CPU, 0), MeshDevice(CPU, 1)] * 2
    hosts = group_devices_by_host(mixed)
    assert [[d.process for d in h] for h in hosts] == [[0, 0], [1, 1]]
    with pytest.raises(ValueError, match="unequal"):
        make_multihost_mesh(devices=mixed[:3])
