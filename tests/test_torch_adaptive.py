"""Adaptive tile masks and bands of rows in the port, against the JAX package.

The engine names of ``select_engine`` against ``tpu_rt``'s (the JAX side
told it is on a TPU, so it routes as it does there); the megakernel's plain
version with ``rows``, ``row_offset`` and ``tile_mask`` stream for stream
against ``render_pallas(..., interpret=True)`` (one JAX compile: the band's
offset and the mask are dynamic there); masks and bands of both plain
versions against their unmasked, full-frame renders; the frame helpers
``accumulate_tiled``, ``cluster_tile_map`` and ``accumulate_tiled_mapped``
against ``tpu_rt``'s; and the app's adaptive controller over
``RayTracer.render_device(tile_mask=)``. The CUDA kernels run on a GPU only
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core import scenes as j_scenes
from tpu_rt.ops.pallas_megakernel import render_pallas
from tpu_rt.render import frame as j_frame

import tpu_rt_torch
from tpu_rt_torch.api import Material, RayTracer, Sphere, Vector3
from tpu_rt_torch.app import run as app_run
from tpu_rt_torch.core import scenes
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.ops.triangle import quad
from tpu_rt_torch.render import frame
from tpu_rt_torch.utils.convert import camera_from_numpy, scene_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
N_ACTIVE = 12  # quantize_count(9, 16)
TILE = mk.TILE


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


# ---- engine names -----------------------------------------------------------

@pytest.fixture
def jax_on_tpu(monkeypatch):
    """The JAX package's routing as on a TPU, where its Pallas engines
    serve (on the CPU it resolves "auto" to its lax engine)."""
    monkeypatch.setattr(j_frame, "_on_tpu", lambda scene: True)


def engine_scene(which):
    """(JAX scene, JAX mesh or None, port scene, port mesh or None)."""
    if which == "demo":
        js = tpu_rt.demo_scene()
        return js, None, scene_from_numpy(to_np_fields(js), CPU), None
    if which == "spheres100":
        js = j_scenes.random_spheres(100, seed=3)
        return js, None, scenes.random_spheres(100, seed=3, device=CPU), None
    # terrain_mesh(n=24): 1058 triangles beside 3 spheres
    js, jm = j_scenes.terrain_mesh(n=24, seed=1)
    ts, tm = scenes.terrain_mesh(n=24, seed=1, device=CPU)
    return js, jm, ts, tm


@pytest.mark.parametrize("which, engine", [
    ("demo", "auto"), ("demo", "pallas"), ("demo", "cluster"),
    ("spheres100", "auto"), ("spheres100", "pallas"), ("mesh1058", "auto"),
    ("mesh1058", "pallas"), ("demo", "lax"), ("demo", "megakernel"),
    ("spheres100", "megakernel")])
def test_select_engine_matches_jax(jax_on_tpu, which, engine):
    js, jm, ts, tm = engine_scene(which)
    if engine == "megakernel":  # a name neither package knows
        with pytest.raises(ValueError):
            j_frame.select_engine(js, mesh=jm, engine=engine)
        with pytest.raises(ValueError):
            frame.select_engine(ts, mesh=tm, engine=engine)
        return
    ref = j_frame.select_engine(js, mesh=jm, engine=engine)
    assert frame.select_engine(ts, mesh=tm, engine=engine) == ref


def test_render_takes_the_pallas_engine_name():
    ts = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    kw = dict(width=32, height=16, spp=1, max_depth=2)
    assert torch.equal(frame.render(ts, cam, 3, engine="pallas", **kw),
                       frame.render(ts, cam, 3, **kw))
    with pytest.raises(ValueError, match="unknown engine"):
        frame.render(ts, cam, 3, engine="megakernel", **kw)


# ---- K1: bands and masks against render_pallas ------------------------------

BW, BH, BR = 128, 96, 72  # a band of 72 rows: 9216 pixels, 3 tiles (ragged)


@pytest.fixture(scope="module")
def band_scenes():
    js = tpu_rt.demo_scene()
    jc = tpu_rt.make_camera(aspect=BW / BH)
    return (js, jc, scene_from_numpy(to_np_fields(js), CPU),
            camera_from_numpy(to_np_fields(jc), CPU))


@pytest.mark.parametrize("row_offset, mask", [
    (0, [1, 0, 1]), (24, [0, 1, 1]), (24, [1, 1, 0]), (0, [0, 0, 0])])
def test_k1_band_and_mask_match_render_pallas(band_scenes, row_offset, mask):
    """One compile serves every case: the offset and the mask are dynamic
    in the JAX kernel. The slack is the flags tests' (transcendental ulps
    between XLA:CPU and torch at depth 2)."""
    js, jc, ts, tc = band_scenes
    kw = dict(width=BW, height=BH, spp=2, max_depth=2, n_active=N_ACTIVE,
              with_stats=True, rows=BR, row_offset=row_offset)
    ref, ref_segs = render_pallas(js, jc, 7, interpret=True,
                                  tile_mask=jnp.asarray(mask, jnp.int32),
                                  **kw)
    ref = np.asarray(ref)
    ours, segs = mk.render_megakernel_reference(
        ts, tc, 7, tile_mask=np.asarray(mask, np.int32), **kw)
    ours = ours.numpy()
    assert ours.shape == ref.shape == (BR, BW, 3)
    d = np.abs(ours - ref)
    assert float((d <= 1e-5).mean()) >= 0.995
    assert float(d.mean()) <= 1e-4
    assert abs(int(segs) - int(ref_segs)) <= 1e-3 * int(ref_segs)
    on = np.repeat(np.asarray(mask) != 0, TILE)[:BR * BW].reshape(BR, BW)
    assert (ours[~on] == 0).all() and (ref[~on] == 0).all()
    if not any(mask):  # every tile skipped: no segment on either side
        assert int(segs) == int(ref_segs) == 0
    else:
        assert (ours[on] > 0).any()


def test_k1_full_height_band_is_the_frame():
    ts = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU)
    kw = dict(width=64, height=32, spp=2, max_depth=2, n_active=N_ACTIVE,
              with_stats=True)
    a, sa = mk.render_megakernel(ts, cam, 4, rows=32, row_offset=0, **kw)
    b, sb = mk.render_megakernel(ts, cam, 4, **kw)
    assert torch.equal(a, b) and int(sa) == int(sb)


# ---- masks on both plain versions ---------------------------------------------

MW, MH = 256, 64  # 4 megakernel tiles or 2x2 screen blocks of 4096 pixels
MASK4 = np.array([1, 0, 0, 1], np.int32)
ALL_ON = dict(enable_refraction=True, enable_dof=True, stratify=True,
              nee=True)


def mask_case(engine, with_mesh):
    """(scene, mesh or None, camera, keywords) of a small masked render."""
    mesh = (quad((-1.5, -0.5, -3.5), (1.5, -0.5, -3.5), (1.5, 1.5, -4.5),
                 (-1.5, 1.5, -4.5), albedo=(0.7, 0.7, 0.7), device=CPU)
            if with_mesh else None)
    if engine == "K1":
        return (tpu_rt_torch.demo_scene(device=CPU), mesh,
                tpu_rt_torch.make_camera(aspect=MW / MH, aperture=0.1,
                                         device=CPU),
                dict(n_active=N_ACTIVE))
    return (scenes.random_spheres(100, seed=3, device=CPU), mesh,
            tpu_rt_torch.make_camera(aspect=MW / MH, aperture=0.1,
                                     position=(0, 3, 14), target=(0, 0, -6),
                                     device=CPU), {})


@pytest.mark.parametrize("with_mesh", [False, True], ids=["spheres", "mesh"])
@pytest.mark.parametrize("flags", ["none", "all"])
@pytest.mark.parametrize("engine", ["K1", "K2"])
def test_masked_plain_equals_unmasked_on_active_tiles(engine, flags,
                                                      with_mesh):
    """Active tiles of a masked render equal the unmasked render bit for
    bit; masked tiles are zeros. The frame is a whole number of tiles, so
    the segment counts are exact: a mask and its complement add up to the
    unmasked render's, so the masked tiles count none."""
    scene, mesh, cam, kw = mask_case(engine, with_mesh)
    render = (mk.render_megakernel if engine == "K1"
              else cluster.render_cluster)
    kw.update(width=MW, height=MH, spp=2, max_depth=2, with_stats=True,
              mesh=mesh, **(ALL_ON if flags == "all" else {}))
    full, s_full = render(scene, cam, 11, **kw)
    part, s_part = render(scene, cam, 11, tile_mask=MASK4, **kw)
    rest, s_rest = render(scene, cam, 11, tile_mask=torch.from_numpy(
        1 - MASK4), **kw)
    if engine == "K1":
        tile = torch.arange(MH * MW).reshape(MH, MW) // TILE
    else:
        tile, n_tiles = frame.cluster_tile_map(MW, MH, device=CPU)
        assert n_tiles == 4
    on = torch.from_numpy(MASK4)[tile.long()] != 0
    assert torch.equal(part[on], full[on]) and torch.equal(rest[~on],
                                                           full[~on])
    assert (part[~on] == 0).all() and (rest[on] == 0).all()
    assert int(s_part) + int(s_rest) == int(s_full)
    assert 0 < int(s_part) < int(s_full)


# ---- K2 bands ------------------------------------------------------------------

@pytest.mark.parametrize("with_mesh", [False, True], ids=["spheres", "mesh"])
def test_k2_bands_stitch_to_the_full_frame(with_mesh):
    """Bands of 32 rows, stitched, equal the full frame bit for bit with
    stratify and NEE on (every stream is keyed by the frame's tile), and
    their segment counts add up."""
    scene, mesh, cam, _ = mask_case("K2", with_mesh)
    kw = dict(width=MW, height=96, spp=2, max_depth=2, with_stats=True,
              mesh=mesh, stratify=True, nee=True)
    full, s_full = cluster.render_cluster(scene, cam, 2**31 - 2, **kw)
    bands = [cluster.render_cluster(scene, cam, 2**31 - 2, rows=32,
                                    row_offset=o, **kw) for o in (0, 32, 64)]
    assert torch.equal(torch.cat([b for b, _ in bands]), full)
    assert sum(int(s) for _, s in bands) == int(s_full)
    # and a band under a mask of its own screen blocks
    band, _ = cluster.render_cluster(scene, cam, 2**31 - 2, rows=32,
                                     row_offset=32, tile_mask=[0, 1], **kw)
    assert (band[:, :128] == 0).all()
    assert torch.equal(band[:, 128:], full[32:64, 128:])


@pytest.mark.parametrize("kw", [
    dict(rows=16), dict(rows=32, row_offset=16), dict(rows=48),
    dict(rows=32, row_offset=64), dict(row_offset=32),
    dict(tile_mask=np.ones(3, np.int32))],
    ids=["rows_16", "offset_16", "rows_48", "past_frame", "offset_only",
         "mask_length"])
def test_k2_rejects_bands_off_the_32_row_grid(kw):
    scene = scenes.random_spheres(100, seed=3, device=CPU)
    cam = tpu_rt_torch.make_camera(device=CPU)
    with pytest.raises(ValueError):
        cluster.render_cluster(scene, cam, 0, width=16, height=64, spp=1,
                               max_depth=1, **kw)


# ---- the frame helpers against tpu_rt -----------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_accumulate_tiled_matches_jax(seed):
    """100x50: two megakernel tiles, the second ragged (its change is
    averaged over 4096 pixels, the padding included, as in the JAX
    package)."""
    rng = np.random.default_rng(seed)
    h, w = 50, 100
    acc = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    batch = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    counts = rng.integers(0, 5, 2).astype(np.float32) * 4
    mask = np.array([1, seed % 2], np.int32)
    ours = frame.accumulate_tiled(
        torch.from_numpy(acc), torch.from_numpy(counts),
        torch.from_numpy(batch), torch.from_numpy(mask), 4, TILE)
    ref = j_frame.accumulate_tiled(
        jnp.asarray(acc), jnp.asarray(counts), jnp.asarray(batch),
        jnp.asarray(mask), 4, TILE)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("w, h", [(200, 70), (128, 32)])
def test_cluster_tile_map_matches_jax(w, h):
    ours, n = frame.cluster_tile_map(w, h, device=CPU)
    ref, n_ref = j_frame.cluster_tile_map(w, h)
    assert n == n_ref and ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [1, 2])
def test_accumulate_tiled_mapped_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 70, 200  # 3 x 2 screen blocks, ragged both ways
    tmap, n_tiles = frame.cluster_tile_map(w, h, device=CPU)
    j_map, _ = j_frame.cluster_tile_map(w, h)
    acc = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    batch = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    counts = rng.integers(0, 5, n_tiles).astype(np.float32) * 2
    mask = rng.integers(0, 2, n_tiles).astype(np.int32)
    ours = frame.accumulate_tiled_mapped(
        torch.from_numpy(acc), torch.from_numpy(counts),
        torch.from_numpy(batch), torch.from_numpy(mask), 2, tmap, n_tiles)
    ref = j_frame.accumulate_tiled_mapped(
        jnp.asarray(acc), jnp.asarray(counts), jnp.asarray(batch),
        jnp.asarray(mask), 2, j_map, n_tiles)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


# ---- the slice as a whole ------------------------------------------------------

W, H, SPP, DEPTH = 128, 80, 2, 4  # 3 megakernel tiles, the last ragged
NOISE_TARGET = 0.2


def test_adaptive_main_path_matches_jax_chain():
    """Three batches of the app's adaptive controller
    (tpu_rt/app/interaction.py:935-962: a tile's streak grows while it is
    active and its change is under the target; it leaves the mask at a
    streak of 2) over RayTracer.render_device(tile_mask=) on the demo
    scene; the same batches merged by the JAX package's accumulate_tiled
    give the same accumulator, counts, changes and masks."""
    rt = RayTracer(device=CPU)
    rt.set_scene(app_run.demo_api_scene())
    n_tiles = -(-(W * H) // TILE)
    mask = np.ones(n_tiles, np.int32)
    streak = {"ours": np.zeros(n_tiles, np.int32),
              "jax": np.zeros(n_tiles, np.int32)}
    acc, counts = torch.zeros((H, W, 3)), torch.zeros(n_tiles)
    j_acc, j_counts = jnp.zeros((H, W, 3)), jnp.zeros(n_tiles)
    masks = []
    for _ in range(3):
        masks.append(mask)
        batch = rt.render_device(W, H, SPP, DEPTH, tile_mask=mask)
        assert rt._last_adaptive and rt._last_engine == "pallas"
        acc, counts, change = frame.accumulate_tiled(
            acc, counts, batch, torch.from_numpy(mask), SPP, TILE)
        j_acc, j_counts, j_change = j_frame.accumulate_tiled(
            j_acc, j_counts, jnp.asarray(batch.numpy()), jnp.asarray(mask),
            SPP, TILE)
        for a, b in ((acc, j_acc), (counts, j_counts), (change, j_change)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        active = mask > 0
        new_mask = {}
        for side, ch in (("ours", change.numpy()),
                         ("jax", np.asarray(j_change))):
            streak[side] = np.where(active & (ch < NOISE_TARGET),
                                    streak[side] + 1, 0)
            new_mask[side] = (active & (streak[side] < 2)).astype(np.int32)
        assert np.array_equal(new_mask["ours"], new_mask["jax"])
        mask = new_mask["ours"]
    # the third batch rendered under a mask with tiles on and off
    assert 0 < masks[2].sum() < n_tiles
    off = np.repeat(masks[2] == 0, TILE)[:W * H].reshape(H, W)
    assert (batch.numpy()[off] == 0).all()
    assert counts.tolist() == [SPP * sum(int(m[t]) for m in masks)
                               for t in range(n_tiles)]


def test_adaptive_mask_is_dropped_on_the_cluster_engine():
    """Past 64 spheres the batch resolves to the cluster engine: as in the
    JAX package the mask is dropped (_last_adaptive False) and the batch
    equals an unmasked one."""
    host = scenes.random_spheres(100, seed=3, device=CPU)
    api = app_run.demo_api_scene()
    api.spheres.clear()
    for i in range(100):
        s = Sphere()
        s.center = Vector3(*host.center[i].tolist())
        s.radius = float(host.radius[i])
        m = Material()
        m.albedo = Vector3(*host.albedo[i].tolist())
        m.emission = Vector3(*host.emission[i].tolist())
        s.material = m
        api.add_sphere(s)
    a, b = RayTracer(seed=2, device=CPU), RayTracer(seed=2, device=CPU)
    a.set_scene(api)
    b.set_scene(api)
    masked = a.render_device(32, 16, 1, 2, tile_mask=np.zeros(1, np.int32))
    assert a._last_engine == "cluster" and not a._last_adaptive
    plain = b.render_device(32, 16, 1, 2)
    assert not b._last_adaptive
    assert torch.equal(masked, plain) and float(plain.max()) > 0
