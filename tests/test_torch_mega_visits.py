"""What the megakernel's rays test, counted by the plain version.

``megakernel_visits_reference`` (the plain version's emulation of the
counting instantiation of ``csrc/megakernel.cu``): its path and shadow
segments against the plain version's per-tile segment counts on the demo
scene, the Cornell box with a bulb under NEE, and a masked band; the shadow
sweep's sphere and triangle tests, up to the first blocker, against counts
worked out by hand on a scene with one blocker between a diffuse plane and
the light; the op model that turns the counts into K1's bound; and the
plain version's segments against ``render_pallas(..., interpret=True)`` at
the blocker scene of ``tests/test_torch_nee.py`` (one JAX compile, the
shape that file compiles). The kernel's own counts are held against these
on a GPU (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import tpu_rt
from tpu_rt.ops import pallas_megakernel as j_mk

import tpu_rt_torch
from tpu_rt_torch.core.scenes import cornell_box
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.ops import triangle as tri
from tpu_rt_torch.utils import roofline as rl
from tpu_rt_torch.utils.convert import camera_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
N_ACTIVE = 12  # quantize_count(9, 16)
CORNELL_POSE = dict(position=(0, 2, 2.5), target=(0, 2, -3))


def cornell_bulb():
    """The Cornell box's two spheres and an emissive bulb under its
    ceiling (the walls occlude some of its shadow rays), and its walls."""
    spheres = tpu_rt_torch.make_scene(
        centers=[(-0.8, 0.6, -3.5), (0.8, 0.5, -2.5), (0.0, 3.3, -3.0)],
        radii=[0.6, 0.5, 0.25],
        albedos=[(0.95, 0.95, 0.95), (0.8, 0.7, 0.3), (1.0, 1.0, 1.0)],
        metallics=[1.0, 0.0, 0.0], roughnesses=[0.02, 0.4, 0.0],
        emissions=[(0, 0, 0), (0, 0, 0), (10.0, 9.0, 8.0)],
        background=(0.0, 0.0, 0.0), device=CPU)
    return spheres, cornell_box(device=CPU)[1]


def plain_tile_segments(scene, cam, seed, **kw):
    """The plain version's per-tile segment counts (n_tiles,)."""
    tables, cam_p, out_rows, row_offset, n_tiles, mask = mk._prepare(
        scene, cam, kw.get("n_active"), kw["width"], kw["height"], kw["spp"],
        kw["max_depth"], kw.get("rows"), kw.get("row_offset", 0),
        kw.get("nee", False), None, kw.get("tile_mask"), kw.get("mesh"),
        kw.get("n_tri_active"))
    _, segs, _ = mk._trace_plain(
        tables.attr, tables.tris, cam_p, tables.background, seed,
        kw["width"], kw["height"], kw["spp"],
        kw["max_depth"], True, n_tiles,
        refract=kw.get("enable_refraction", False),
        stratify=kw.get("stratify", False), nee=kw.get("nee", False),
        out_rows=out_rows, row_offset=row_offset, mask=mask)
    return segs


def visit_cases():
    demo = tpu_rt_torch.demo_scene(device=CPU)
    spheres, walls = cornell_bulb()
    return {
        "demo": (demo, {}, dict(n_active=N_ACTIVE)),
        "demo_nee": (demo, {}, dict(n_active=N_ACTIVE, nee=True)),
        "cornell_bulb_nee": (spheres, CORNELL_POSE, dict(
            mesh=walls, n_active=4, n_tri_active=12, nee=True,
            enable_refraction=True, stratify=True)),
        # 40 rows from row 88 of 128: three tiles, the last ragged; the
        # middle one masked
        "masked_band_nee": (demo, {}, dict(
            n_active=N_ACTIVE, nee=True, rows=40, row_offset=88,
            tile_mask=np.array([1, 0, 1], np.int32))),
    }


@pytest.mark.parametrize("case", ["demo", "demo_nee", "cornell_bulb_nee",
                                  "masked_band_nee"])
def test_visit_segments_sum_to_plain_segments(case):
    """Per tile, the path and shadow segments sum to the plain version's
    segment count; every path segment sweeps every sphere and triangle
    row; a shadow ray tests at most every row and a masked tile counts
    nothing; the image and total are the uncounted render's."""
    scene, pose, extra = visit_cases()[case]
    cam = tpu_rt_torch.make_camera(aspect=2.0, device=CPU, **pose)
    kw = dict(width=256, height=128, spp=2, max_depth=4, **extra)
    vis = mk.megakernel_visits_reference(scene, cam, 11, **kw)
    segs = plain_tile_segments(scene, cam, 11, **kw)
    n_tiles = segs.shape[0]
    assert vis.shape == (n_tiles, 2, 4) and vis.dtype == torch.int64
    assert torch.equal(vis[:, 0, 0] + vis[:, 1, 0], segs.long())
    n_sph = extra["n_active"]
    n_tri = extra.get("n_tri_active", 0)
    assert torch.equal(vis[:, 0, 1], vis[:, 0, 0] * n_sph)
    assert torch.equal(vis[:, 0, 2], vis[:, 0, 0] * n_tri)
    assert bool((vis[:, 1, 1] <= vis[:, 1, 0] * n_sph).all())
    assert bool((vis[:, 1, 2] <= vis[:, 1, 0] * n_tri).all())
    assert bool((vis[..., 3] == -1).all())
    if extra.get("nee"):
        assert int(vis[:, 1, 0].sum()) > 0 and int(vis[:, 1, 1].sum()) > 0
    else:
        assert not vis[:, 1, :3].any()
    if "tile_mask" in extra:
        assert not vis[1, :, :3].any() and int(vis[0, 0, 0]) > 0
    img, total, vis2 = mk.render_megakernel(
        scene, cam, 11, with_stats=True, with_visits=True, **kw)
    img0, total0 = mk.render_megakernel(scene, cam, 11, with_stats=True, **kw)
    assert torch.equal(img, img0) and int(total) == int(total0)
    assert torch.equal(vis2, vis)


def blocker_plane(blocker_first: bool, blocked: bool):
    """A diffuse floor quad (2 triangles) under a camera that sees only the
    floor; a small light far to its side at (20, 3, 0); and a large opaque
    sphere at (10, 1.5, 0), on every line from the seen floor to the light,
    or at (-10, 1.5, 0), on none of them; both spheres out of the camera's
    view. Returns (scene, mesh, camera, frame keywords)."""
    light = ((20.0, 3.0, 0.0), 0.5, (1.0, 1.0, 1.0), (50.0, 50.0, 50.0))
    block = ((10.0 if blocked else -10.0, 1.5, 0.0), 3.0, (0.5, 0.5, 0.5),
             (0.0, 0.0, 0.0))
    rows = [block, light] if blocker_first else [light, block]
    scene = tpu_rt_torch.make_scene(
        centers=[r[0] for r in rows], radii=[r[1] for r in rows],
        albedos=[r[2] for r in rows], metallics=[0.0, 0.0],
        roughnesses=[0.5, 0.5], emissions=[r[3] for r in rows],
        background=(0.0, 0.0, 0.0), device=CPU)
    floor = tri.quad((-10, 0, -10), (-10, 0, 10), (10, 0, 10), (10, 0, -10),
                     albedo=(0.7, 0.7, 0.7), device=CPU)
    cam = tpu_rt_torch.make_camera(position=(0, 4, 4), target=(0, 0, 0),
                                   fov=20.0, aspect=1.0, device=CPU)
    # 64 x 64: one whole tile, no lanes past the last pixel; depth 1:
    # one path segment and one shadow ray per pixel
    kw = dict(width=64, height=64, spp=1, max_depth=1, jitter=False,
              n_active=2, mesh=floor, n_tri_active=2, nee=True)
    return scene, floor, cam, kw


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "open"])
@pytest.mark.parametrize("blocker_first", [True, False],
                         ids=["blocker_first", "light_first"])
def test_shadow_tests_counted_by_hand(blocker_first, blocked):
    """4096 pixels see the floor, so 4096 path segments test 2 spheres and
    2 triangles each, and each diffuse floor hit sends one shadow ray to
    the light. A blocked ray stops at the blocker: 1 sphere test when the
    blocker is row 0, 2 when the light is, and no triangle test; an open
    ray tests both spheres and both triangles."""
    scene, _, cam, kw = blocker_plane(blocker_first, blocked)
    vis = mk.megakernel_visits_reference(scene, cam, 5, **kw)
    n = 64 * 64
    assert vis[0, 0, :3].tolist() == [n, 2 * n, 2 * n]
    if blocked:
        want = [n, (1 if blocker_first else 2) * n, 0]
    else:
        want = [n, 2 * n, 2 * n]
    assert vis[0, 1, :3].tolist() == want
    # the image: the blocked floor gets no direct light at depth 1
    img = mk.render_megakernel(scene, cam, 5, gamma=False, **kw)
    assert (float(img.max()) == 0.0) == blocked


def test_op_model_counts_the_shadow_sweep():
    """With the counts, K1's bound takes the counted split of path and
    shadow segments and adds the shadow rays' sphere and triangle tests at
    their op counts; it exceeds the model without them, which takes half
    of the segments as shadow segments and no sweep."""
    scene, _, cam, kw = blocker_plane(False, False)
    vis = mk.megakernel_visits_reference(scene, cam, 5, **kw)
    segs = int(vis[:, :, 0].sum())
    n_pix, flags = 64 * 64, {"nee": True}
    ops = rl.megakernel_op_model(segs, n_pix, 1, 2, n_tris=2, flags=flags,
                                 visits=vis)
    path = n_pix * (2 * 24 + 2 * 53)   # 4096 path segments, no shading
    shadow = n_pix * 120               # one shadow segment per pixel
    sweep = n_pix * (2 * 24 + 2 * 53)  # every shadow ray is open
    assert rl.megakernel_sweep_ops(vis) == sweep
    assert ops == path + shadow + sweep + n_pix * 33 + n_pix * 15
    assert ops > rl.megakernel_op_model(segs, n_pix, 1, 2, n_tris=2,
                                        flags=flags)
    with pytest.raises(ValueError, match="segments"):
        rl.megakernel_op_model(segs + 1, n_pix, 1, 2, n_tris=2, flags=flags,
                               visits=vis)


def test_op_model_takes_the_with_stats_count_of_a_ragged_frame():
    """A frame of 80x60 pixels fills two 4096-ray tiles, the second
    ragged: ``with_stats`` reports the traced segments scaled to the real
    pixels. The op model with the counts takes that count or the traced
    one alike, counts every traced segment, and refuses any other."""
    demo = tpu_rt_torch.demo_scene(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=80 / 60, device=CPU)
    kw = dict(width=80, height=60, spp=2, max_depth=3, n_active=N_ACTIVE,
              nee=True)
    _, segs, vis = mk.render_megakernel_reference(
        demo, cam, 3, with_stats=True, with_visits=True, **kw)
    traced = int(vis[:, :, 0].sum())
    assert vis.shape[0] == 2 and int(segs) < traced
    n_pix, flags = 80 * 60, {"nee": True}
    model = [rl.megakernel_op_model(n, n_pix, 2, N_ACTIVE, flags=flags,
                                    visits=vis) for n in (int(segs), traced)]
    assert model[0] == model[1] == (
        rl.path_ops(traced, n_pix, 2, N_ACTIVE * rl.SPHERE_TEST_OPS, flags,
                    int(vis[:, 1, 0].sum())) + rl.megakernel_sweep_ops(vis))
    with pytest.raises(ValueError, match="segments"):
        rl.megakernel_op_model(int(segs) - 1, n_pix, 2, N_ACTIVE,
                               flags=flags, visits=vis)


def test_ptxas_lines_name_each_megakernel_instantiation():
    """kernels/build.py:ptxas_lines reads the registers and spills of
    every megakernel instantiation from ptxas's report, by its template
    arguments, and skips the other kernels."""
    from tpu_rt_torch.kernels import build
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_110megakernelILb1ELb1ELb1ELb0EEEvPKfi' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill "
        "loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_Z14cluster_kernelILb0EEvPKf' for 'sm_90a'",
        "ptxas info    : Used 96 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_110megakernelILb0ELb0ELb0ELb0EEEvPKfi' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 60 registers",
    ])
    assert build.ptxas_lines(log) == [
        "<1, 1, 1, 0>: 64 registers; 24 bytes stack frame, 24 bytes spill "
        "stores, 24 bytes spill loads",
        "<0, 0, 0, 0>: 60 registers; 0 bytes stack frame, 0 bytes spill "
        "stores, 0 bytes spill loads"]


def test_plain_segments_equal_the_jax_kernel_with_nee():
    """The blocker scene of tests/test_torch_nee.py (its shape, so its
    compile) at seed 7: the plain version's segments, which its counts
    split into path and shadow segments, against render_pallas
    (interpret=True)."""
    rows = dict(
        centers=[(0, -100.5, -3), (0, 0.2, -3), (1.2, 0.2, -3),
                 (-1.0, 2.5, -2.5), (-0.5, 1.3, -2.75)],
        radii=[100.0, 0.7, 0.5, 0.35, 0.45],
        albedos=[(0.6, 0.6, 0.6), (0.7, 0.3, 0.3), (0.8, 0.8, 0.4),
                 (1.0, 1.0, 1.0), (0.2, 0.2, 0.2)],
        metallics=[0.0, 0.0, 1.0, 0.0, 0.0],
        roughnesses=[0.5, 0.5, 0.4, 0.0, 0.5],
        emissions=[(0, 0, 0), (0, 0, 0), (0, 0, 0), (14.0, 12.0, 10.0),
                   (0, 0, 0)],
        background=(0.0, 0.0, 0.0))
    js = tpu_rt.make_scene(**rows)
    ts = tpu_rt_torch.make_scene(**rows, device=CPU)
    pose = dict(position=(0, 1.0, 2.0), target=(0, 0.2, -3))
    jcam = tpu_rt.make_camera(aspect=100 / 40, **pose)
    tcam = camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()}, CPU)
    kw = dict(width=100, height=40, spp=2, max_depth=4, nee=True,
              gamma=False, with_stats=True, n_active=8)
    _, ref_segs = j_mk.render_pallas(js, jcam, 7, interpret=True, **kw)
    _, segs, vis = mk.render_megakernel_reference(ts, tcam, 7,
                                                  with_visits=True, **kw)
    assert int(segs) == int(ref_segs)
    # 4000 pixels of one 4096-lane tile: the total is scaled by 4000/4096
    raw = int(vis[:, :, 0].sum())
    assert int(segs) == int(np.float32(raw) * np.float32(4000 / 4096))
    assert int(vis[0, 1, 0]) > 0
