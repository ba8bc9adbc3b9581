"""The port's interactive runtime (tpu_rt_torch.app): every flow of
tests/test_app.py on the CPU, and whole sessions held against their chains.

Sessions run at 48x36/2spp/d2 on ``device="cpu"``, where each kernel runs
its plain version. A progressive session's accumulator equals
RayTracer.render_device -> accumulate driven by hand with the same seeds,
bit for bit, and the JAX package's ``render_pallas(interpret=True)``
chained with the RayTracer's seeds within tests/test_torch_slice.py's
bounds (the file's one JAX interpret compile); the NEE and adaptive-tile
sessions equal the port's hand-driven chains.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import tpu_rt
import tpu_rt.api
import tpu_rt.app
import tpu_rt.app.interaction
from tpu_rt.ops.pallas_megakernel import render_pallas
from tpu_rt.render import display as j_display
from tpu_rt.render import frame as j_frame

from tpu_rt_torch.api import RayTracer, Vector3
from tpu_rt_torch.api.compat import batch_seed
from tpu_rt_torch.app import (
    FrameRateLimiter,
    RayTracerInteraction,
    RenderMode,
    SceneManager,
)
from tpu_rt_torch.app.interaction import procedural_noise_color
from tpu_rt_torch.ops.megakernel import TILE, render_megakernel
from tpu_rt_torch.render import display, frame

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
W, H, SPB, DEPTH = 48, 36, 2, 2


def session(w=W, h=H, **settings):
    r = RayTracerInteraction(w, h, device="cpu")
    r.settings.update(max_samples=4, samples_per_batch=SPB, max_depth=DEPTH)
    r.settings.update(settings)
    return r


@pytest.fixture
def rti():
    r = session()
    yield r
    r.stop_rendering()


def drain(rti, timeout=30.0, want_done=True):
    frames = []
    t0 = time.time()
    while time.time() - t0 < timeout:
        f = rti.get_frame()
        if f is None:
            time.sleep(0.02)
            continue
        frames.append(f)
        if want_done and f.get("done"):
            break
    return frames


def run_session(r, timeout=60.0):
    """Start ``r``, drain it to its done frame and stop it."""
    try:
        r.start_rendering()
        frames = drain(r, timeout=timeout)
    finally:
        r.stop_rendering()
    assert frames and frames[-1].get("done"), "the session did not finish"
    return frames


def hand_chain(batches, w=W, h=H, spp=SPB, depth=DEPTH, nee=False):
    """RayTracer.render_device -> accumulate on the interactive scene,
    driven by hand with the session's seeds (RayTracer(seed=0))."""
    rt = RayTracer(device=CPU)
    rt.set_scene(SceneManager.create_interactive_scene())
    rt.set_nee(nee)
    acc, total = None, 0
    for _ in range(batches):
        acc, total = frame.accumulate(acc, total,
                                      rt.render_device(w, h, spp, depth), spp)
    return acc, total


def test_scene_factory_matches_reference_layout():
    scene = SceneManager.create_interactive_scene()
    assert len(scene.spheres) == 9
    names = [s.name for s in scene.spheres]
    assert names[0] == "Ground" and "Main Light" in names
    assert scene.background_color.z == 0.1
    light = scene.spheres[6]
    assert light.material.emission.x == 10
    j_scene = tpu_rt.app.SceneManager.create_interactive_scene()
    for a, b in zip(scene.spheres, j_scene.spheres):
        assert (a.name, a.object_id, a.radius) == (b.name, b.object_id,
                                                    b.radius)
        assert a.center.to_array().tolist() == b.center.to_array().tolist()


def test_progressive_render_to_completion(rti):
    before = render_megakernel.launches
    frames = run_session(rti)
    # noise_target defaults OFF: runs to max_samples, never "converged"
    assert frames[-1].get("converged") is False
    rt_frames = [f for f in frames if "display" in f]
    assert rt_frames, "no raytracing frames produced"
    last = rt_frames[-1]
    assert last["samples"] == 4
    assert last["mode"] == "raytracing"
    assert last["d2h"] == 1  # one pull of the uint8 stack per frame
    img = last["display"]
    assert img.shape == (36, 48, 3)
    assert img.dtype == np.uint8  # quantized on the device
    assert img.max() > 12  # scene is lit (uint8 scale)
    assert last["enhanced"].shape == img.shape
    # CPU tensors: the plain version, never the kernel
    assert render_megakernel.launches == before
    assert rti.ray_tracer._last_engine == "pallas"


def test_session_equals_hand_chain_and_jax_chain():
    """Two batches of a session: bit for bit the port's hand-driven chain,
    and within tests/test_torch_slice.py's bounds of render_pallas
    (interpret mode) chained with the RayTracer's seeds."""
    r = session()
    frames = run_session(r)
    acc = torch.from_numpy(r.accumulated_image)
    assert r.total_samples == 4
    ours, total = hand_chain(2)
    assert total == 4 and torch.equal(acc, ours)
    last = [f for f in frames if "display" in f][-1]
    stack = display.display_stack(acc, 1.5, as_uint8=True).numpy()
    assert np.array_equal(last["display"], stack[0])
    assert np.array_equal(last["enhanced"], stack[1])

    js = tpu_rt.demo_scene()
    jc = tpu_rt.make_camera(aspect=W / H)
    j_acc, j_total = None, 0
    for f in range(2):
        img = render_pallas(js, jc, batch_seed(1, f), width=W, height=H,
                            spp=SPB, max_depth=DEPTH, interpret=True,
                            n_active=12)
        j_acc, j_total = j_frame.accumulate(j_acc, j_total, img, SPB)
    j_stack = np.asarray(j_display.display_stack(j_acc, 1.5, as_uint8=True))
    lsb = np.abs(stack.astype(int) - j_stack.astype(int))
    assert float((lsb <= 1).mean()) >= 0.99
    assert float(np.abs(acc.numpy() - np.asarray(j_acc)).mean()) <= 1e-4


def test_nee_session_equals_hand_chain():
    r = session(nee=True)
    run_session(r)
    assert r.ray_tracer._nee is True
    assert r.ray_tracer._last_engine == "pallas"
    ours, total = hand_chain(2, nee=True)
    assert r.total_samples == total == 4
    assert torch.equal(torch.from_numpy(r.accumulated_image), ours)
    plain, _ = hand_chain(2)
    assert not torch.equal(ours, plain)


AW, AH, ADEPTH = 128, 80, 4  # 3 megakernel tiles, the last ragged


def test_adaptive_session_equals_hand_chain():
    """adaptive_tiles + noise_target: the session's accumulator, per-tile
    counts and active tiles equal the app's per-tile controller
    (tpu_rt/app/interaction.py:935-962) driven by hand over
    RayTracer.render_device(tile_mask=) -> accumulate_tiled."""
    target = 0.2
    r = session(AW, AH, max_samples=8, max_depth=ADEPTH, noise_target=target,
                adaptive_tiles=True)
    frames = run_session(r)
    rt_frames = [f for f in frames if "display" in f]

    rt = RayTracer(device=CPU)
    rt.set_scene(SceneManager.create_interactive_scene())
    n_tiles = -(-(AW * AH) // TILE)
    mask = np.ones(n_tiles, np.int32)
    streak = np.zeros(n_tiles, np.int32)
    acc, counts = torch.zeros((AH, AW, 3)), torch.zeros(n_tiles)
    masks = []
    while counts.max() < 8 and mask.any():
        masks.append(mask)
        batch = rt.render_device(AW, AH, SPB, ADEPTH, tile_mask=mask)
        acc, counts, change = frame.accumulate_tiled(
            acc, counts, batch, torch.from_numpy(mask), SPB, TILE)
        active = mask > 0
        streak = np.where(active & (change.numpy() < target), streak + 1, 0)
        mask = (active & (streak < 2)).astype(np.int32)
    assert any(0 < m.sum() < n_tiles for m in masks[1:]), [
        int(m.sum()) for m in masks]
    assert torch.equal(torch.from_numpy(r.accumulated_image), acc)
    assert r.total_samples == int(counts.max())
    assert [f["active_tiles"] for f in rt_frames][-1] == int(mask.sum())
    assert rt_frames[-1]["n_tiles"] == n_tiles
    c = counts.numpy()
    assert rt_frames[-1]["tile_samples"] == (int(c.min()), int(np.median(c)),
                                             int(c.max()))
    assert frames[-1]["converged"] is (not mask.any())


def test_noise_target_auto_stops_converged_render():
    """Beyond-reference progressive auto-stop: with a loose noise target
    the worker stops as soon as two consecutive batches stop changing the
    accumulated image, well before max_samples."""
    r = session(max_samples=1024, noise_target=0.5)
    frames = run_session(r)
    assert frames[-1]["converged"] is True
    rt = [f for f in frames if "display" in f]
    # stopped after the 2-batch convergence streak, far below max_samples
    assert rt and rt[-1]["samples"] <= 8, rt[-1]["samples"]


def test_camera_keys_switch_to_wireframe_and_back(rti):
    rti.start_rendering()
    rti.set_camera_key_state("forward", True)
    assert rti.render_state.current_mode == RenderMode.WIREFRAME
    # drain while the key is held: restart_rendering() on release swaps the
    # frame queue, discarding preview frames
    time.sleep(0.2)
    frames = drain(rti, want_done=False, timeout=2)
    modes = {f.get("mode") for f in frames if "mode" in f}
    assert "wireframe" in modes
    rti.set_camera_key_state("forward", False)
    assert rti.render_state.current_mode == RenderMode.RAYTRACING


def test_camera_movement_moves_position(rti):
    z0 = rti.camera.position.z
    rti.set_camera_key_state("forward", True)
    time.sleep(0.3)
    rti.set_camera_key_state("forward", False)
    assert rti.camera.position.z < z0  # moved toward target


def test_camera_rotation_flow(rti):
    t0 = rti.camera.target
    before = (t0.x, t0.y, t0.z)
    rti.start_camera_rotation(0.5, 0.5)
    rti.update_camera_rotation(30.0 / 640, 0.0)
    rti.stop_camera_rotation()
    t1 = rti.camera.target
    assert (t1.x, t1.y, t1.z) != before
    assert rti.render_state.current_mode == RenderMode.RAYTRACING


def test_selection_and_drag(rti):
    found = False
    for x in np.linspace(0.1, 0.45, 12):
        for y in np.linspace(0.4, 0.7, 8):
            if rti.select_object_by_click(float(x), float(y)):
                found = True
                break
        if found:
            break
    assert found, "no object selectable by scanning screen"
    sel = rti.get_selected_object()
    assert sel is not None and sel.object_id > 0

    start = rti.start_object_dragging(float(x), float(y))
    assert start
    assert rti.render_state.current_mode == RenderMode.SILHOUETTE
    cx = sel.center.x
    rti.update_object_dragging(0.1, 0.0)
    assert sel.center.x != cx
    rti.stop_object_dragging()
    assert rti.render_state.current_mode == RenderMode.RAYTRACING


def test_dimension_locks(rti):
    rti.settings["selected_object"] = 1
    rti.object_dragger.selected_object_id = 1
    obj = rti.get_selected_object()
    rti.object_dragger.dragging = True
    rti.object_dragger.drag_start_object_pos = Vector3(
        obj.center.x, obj.center.y, obj.center.z)
    rti.set_dimension_lock("x", True)
    x0, y0 = obj.center.x, obj.center.y
    rti.object_dragger.update_drag(0.3, 0.3)
    assert obj.center.x == x0  # locked
    assert obj.center.y != y0
    rti.object_dragger.stop_drag()
    assert not rti.object_dragger.lock_x  # locks clear on stop


def test_object_crud(rti):
    n0 = rti.get_object_count()
    new_id = rti.add_object_to_scene()
    assert rti.get_object_count() == n0 + 1
    assert rti.settings["selected_object"] == new_id
    assert rti.remove_object_from_scene(new_id)
    assert rti.get_object_count() == n0
    assert not rti.remove_object_from_scene(12345)


def test_material_edits(rti):
    rti.settings["selected_object"] = 1
    obj = rti.get_selected_object()
    rti.set_object_color(0.1, 0.2, 0.3, apply_immediate=False)
    assert abs(obj.material.albedo.y - 0.2) < 1e-9
    rti.set_object_color_hsv(0, 1, 1, apply_immediate=False)  # pure red
    assert obj.material.albedo.x == 1.0 and obj.material.albedo.y == 0.0
    rti.update_object_material("roughness", 0.7)
    assert obj.material.roughness == 0.7
    # light intensity scaling preserves ratios
    rti.settings["selected_object"] = 6  # Main Light (10,10,8)
    rti.update_light_intensity(5.0)
    e = rti.get_selected_object().material.emission
    assert abs(e.x - 5.0) < 1e-6 and abs(e.z - 4.0) < 1e-6


def test_procedural_texture(rti):
    rti.settings["selected_object"] = 2
    obj = rti.get_selected_object()
    before = (obj.material.albedo.x, obj.material.albedo.y)
    assert rti.set_object_texture("noise", {"scale": 2.0, "octaves": 3})
    after = (obj.material.albedo.x, obj.material.albedo.y)
    assert after != before
    assert rti.set_object_texture("none", {})
    assert not rti.set_object_texture("marble", {})
    c1 = procedural_noise_color(Vector3(1, 2, 3), 1.5, 3)
    assert c1 == procedural_noise_color(Vector3(1, 2, 3), 1.5, 3)
    # the JAX package's function gives the same color
    j_c = tpu_rt.app.interaction.procedural_noise_color(
        tpu_rt.api.Vector3(1, 2, 3), 1.5, 3, base_hsv=(120, 0.5, 0.8))
    assert procedural_noise_color(Vector3(1, 2, 3), 1.5, 3,
                                  base_hsv=(120, 0.5, 0.8)) == j_c


def test_resize_viewport(rti):
    assert rti.resize_viewport(32, 24)
    rti.start_rendering()
    frames = drain(rti)
    rt = [f for f in frames if "display" in f]
    assert rt and rt[-1]["display"].shape == (24, 32, 3)


def test_denoised_frames(rti):
    rti.settings["show_denoisers"] = True
    rti.settings["selected_denoisers"] = ["gaussian", "median"]
    rti.start_rendering()
    frames = drain(rti)
    rt = [f for f in frames if f.get("denoised")]
    assert rt, "no denoised frames"
    d = rt[-1]["denoised"]
    assert set(d) == {"gaussian", "median"}
    # default denoiser_grid_scale=2: grid tiles come back at half size
    assert d["gaussian"].shape == (18, 24, 3)
    # the last frame's grid is display_stack's over the final accumulator
    stack = display.display_stack(torch.from_numpy(rti.accumulated_image),
                                  1.5, methods=("gaussian", "median"),
                                  as_uint8=True, grid_scale=2)
    tiles = display.unpack_grid(stack[2].numpy(), ("gaussian", "median"), 2)
    for m in ("gaussian", "median"):
        assert np.array_equal(d[m], tiles[m])


def test_joint_denoiser_frame(rti):
    """The feature-guided method rides a frame with a stacked method as a
    second pull, over the cached first-hit AOVs on the tracer's device."""
    rti.settings["show_denoisers"] = True
    rti.settings["selected_denoisers"] = ["gaussian", "joint"]
    rti.start_rendering()
    frames = drain(rti)
    rt = [f for f in frames if f.get("denoised")]
    assert rt and set(rt[-1]["denoised"]) == {"gaussian", "joint"}
    assert rt[-1]["d2h"] == 2
    assert rt[-1]["denoised"]["joint"].shape == (36, 48, 3)
    assert rti._aov_cache["normal"].device == CPU


def test_previews_draw_content(rti):
    sil = rti.renderer.render_silhouette(1)
    wf = rti.renderer.render_wireframe(1)
    assert sil.sum() > 0 and wf.sum() > 0
    # wireframe includes the grid (gray pixels), silhouette does not
    assert (wf.sum() > sil.sum())
    cyan = (sil[..., 1] > 0.9) & (sil[..., 2] > 0.9) & (sil[..., 0] < 0.1)
    assert cyan.any()
    from tpu_rt_torch.app.preview import PreviewRenderer

    big = PreviewRenderer(320, 240, rti.camera, rti.scene)
    sil_big = big.render_silhouette(1)
    yellow = ((sil_big[..., 0] > 0.9) & (sil_big[..., 1] > 0.9)
              & (sil_big[..., 2] < 0.1))
    assert yellow.any()


def test_frame_rate_limiter():
    lim = FrameRateLimiter(1000)
    assert lim.should_update()
    lim.update()
    lim2 = FrameRateLimiter(0.5)
    lim2.update()
    assert not lim2.should_update()


def test_reset_camera(rti):
    rti.camera.position = Vector3(5, 5, 5)
    rti.reset_camera_and_rerender()
    assert rti.camera.position.z == 5 and rti.camera.position.y == 2


def test_session_save_load(rti, tmp_path):
    rti.start_rendering()
    drain(rti)
    assert rti.total_samples == 4
    # raise the target before saving so the restored session has headroom
    rti.settings["max_samples"] = 8
    path = str(tmp_path / "sess.npz")
    rti.save_session(path)

    # fresh runtime, restore: accumulator and settings resume
    r2 = RayTracerInteraction(48, 36, device="cpu")
    try:
        r2.load_session(path)
        assert r2.settings["max_samples"] == 8
        drain(r2)
        assert r2.total_samples == 8
    finally:
        r2.stop_rendering()


def test_session_saved_by_jax_package_resumes():
    """A session the JAX package saved loads in the port with its
    accumulator, sample count and settings (saved at max_samples, so the
    resumed worker adds nothing)."""
    import tempfile

    j_rt = tpu_rt.app.RayTracerInteraction(W, H)
    try:
        j_rt.settings.update(max_samples=4, samples_per_batch=SPB)
        acc = np.random.default_rng(5).uniform(0, 1, (H, W, 3)).astype(
            np.float32)
        j_rt.accumulated_image = acc
        j_rt.total_samples = 4
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "jax_session.npz")
            j_rt.save_session(path)
            r = RayTracerInteraction(W, H, device="cpu")
            try:
                r.load_session(path)
                assert drain(r)[-1]["done"]
                assert r.total_samples == 4
                assert np.array_equal(r.accumulated_image, acc)
                assert r.settings["samples_per_batch"] == SPB
            finally:
                r.stop_rendering()
    finally:
        j_rt.stop_rendering()


def test_frame_stats_tracked(rti):
    rti.start_rendering()
    drain(rti)
    assert rti.frame_stats.times, "no frame timings recorded"
    assert rti.frame_stats.mrays_per_s > 0


def test_linear_accumulation_mode():
    """linear_accumulation=True accumulates RayTracer(linear=True)'s
    pre-gamma batches (the lax engine), bit for bit the hand-driven chain,
    and displays them with the gamma applied."""
    r = RayTracerInteraction(W, H, linear_accumulation=True, device="cpu")
    r.settings.update(max_samples=4, samples_per_batch=SPB, max_depth=DEPTH)
    assert r.settings["linear_accumulation"] is True
    frames = run_session(r)
    assert r.ray_tracer._last_engine == "lax"
    rt = RayTracer(linear=True, device=CPU)
    rt.set_scene(SceneManager.create_interactive_scene())
    acc, total = None, 0
    for _ in range(2):
        acc, total = frame.accumulate(
            acc, total, rt.render_device(W, H, SPB, DEPTH), SPB)
    assert r.total_samples == total == 4
    assert np.array_equal(r.accumulated_image, acc.numpy())
    assert float(acc.max()) > 1.0  # linear radiance, before the gamma
    shown = [f for f in frames if "display" in f][-1]["display"]
    ref = display.display_stack(acc, r.settings["exposure"], linear=True,
                                enhance=True, as_uint8=True)
    assert np.array_equal(np.asarray(shown), ref[0].numpy())


def test_mesh_attach_render_and_session_roundtrip(rti, tmp_path):
    """Attach a triangle mesh, render headlessly, round-trip it through a
    saved session."""
    from tpu_rt_torch.ops.triangle import box

    n = 12
    rti.set_mesh(box(center=(0, 1, -3), size=(1.5, 1.5, 1.5),
                     albedo=(0.9, 0.2, 0.1), device=CPU))
    assert rti.ray_tracer._mesh is not None
    rti.start_rendering()
    frames = drain(rti)
    assert frames and frames[-1].get("done")
    img = next(f["display"] for f in frames if "display" in f)
    assert np.isfinite(img).all()

    p = str(tmp_path / "mesh_session.npz")
    rti.save_session(p)

    r2 = RayTracerInteraction(48, 36, device="cpu")
    try:
        r2.load_session(p)
        assert r2.mesh is not None
        assert int(r2.mesh.valid.sum()) == n and r2.mesh.device == CPU
        assert r2.ray_tracer._mesh is not None
        frames2 = drain(r2)
        assert frames2
    finally:
        r2.stop_rendering()

    # clearing the mesh goes back to spheres-only
    rti.set_mesh(None)
    assert rti.ray_tracer._mesh is None


def test_load_mesh_from_obj(rti, tmp_path):
    from tpu_rt_torch.ops.triangle import box
    from tpu_rt_torch.utils.objio import save_obj

    p = str(tmp_path / "b.obj")
    save_obj(p, box(center=(0, 1, -3), size=(1, 1, 1), device=CPU))
    count = rti.load_mesh_from_obj(p, default_albedo=(0.2, 0.8, 0.3))
    assert count == 12
    assert rti.mesh is not None and rti.mesh.device == CPU


def test_headless_cli_with_obj_and_dof(tmp_path):
    """The launcher's headless mode end-to-end with an OBJ mesh and
    depth-of-field flags."""
    from tpu_rt_torch.app import run as app_run
    from tpu_rt_torch.ops.triangle import box
    from tpu_rt_torch.utils.objio import save_obj

    obj = str(tmp_path / "b.obj")
    save_obj(obj, box(center=(0, 1, -3), size=(1, 1, 1), device=CPU))
    out = str(tmp_path / "r.png")
    rc = app_run.main([
        "--headless", "--device", "cpu", "--width", "48", "--height", "36",
        "--samples", "4", "--batch", "2", "--depth", "2",
        "--obj", obj, "--aperture", "0.2", "--focus-dist", "5.0",
        "--output", out, "--timeout", "240",
    ])
    assert rc == 0
    assert os.path.exists(out) or os.path.exists(out + ".npy")


def test_headless_cli_reports_platform_and_times_out(tmp_path, capsys):
    from tpu_rt_torch.app import run as app_run

    rc = app_run.main(["--headless", "--device", "cpu", "--width", "48",
                       "--height", "36", "--samples", "4", "--batch", "2",
                       "--depth", "2", "--timeout", "0",
                       "--output", str(tmp_path / "t.png")])
    out = capsys.readouterr().out
    assert rc == 1 and "no frames rendered before timeout" in out
    assert f"torch {torch.__version__}" in out
    assert app_run.check_environment()


def test_nee_setting_flows_to_renderer(rti):
    """The `nee` knob must reach the estimator: the worker syncs it per
    batch. The batch stays on the megakernel (its plain version here)."""
    rti.settings["nee"] = True
    frames = run_session(rti, timeout=120.0)
    assert rti.ray_tracer._nee is True
    assert rti.ray_tracer._last_engine == "pallas"
    rt_frames = [f for f in frames if "display" in f]
    assert rt_frames and np.isfinite(rt_frames[-1]["display"]).all()


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["whole", "adaptive"])
def test_restarted_session_keeps_one_accumulator(rti, adaptive):
    """Restarts while workers run open new sessions: the old workers stop
    (stop_rendering joins every one), and the last session still ends at
    max_samples, its frames counting its own batches alone, with adaptive
    tiles too (where a worker writes its tile counts after pulling them).
    Thread switches are forced often to shake out lost updates."""
    if adaptive:
        # a noise target no tile reaches: every tile runs to max_samples
        rti.settings.update(adaptive_tiles=True, noise_target=1e-30)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rti.start_rendering()
        for _ in range(8):
            time.sleep(0.003)
            rti.restart_rendering()
        frames = drain(rti)
        rti.stop_rendering(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert frames and frames[-1].get("done")
    assert frames[-1]["converged"] is False
    assert rti.total_samples == 4
    assert not any(t.name == "tpu_rt-render" and t.is_alive()
                   for t in threading.enumerate())
    shown = [f for f in frames if "display" in f]
    assert [f["samples"] for f in shown] == [2, 4], shown
    assert all((f["n_tiles"] is not None) is adaptive for f in shown)


def test_restart_during_adaptive_pull_leaves_new_session_alone(
        rti, monkeypatch):
    """An adaptive worker pulls its tile counts outside the render lock.
    A restart that lands in that pull, and a whole new session that runs
    to its end there, are left alone: the old worker, resuming, writes
    none of the shared state (total samples, tile stats, active tiles)."""
    from tpu_rt_torch.app import interaction as app_interaction

    accumulate_tiled = app_interaction.accumulate_tiled
    inner = {}

    class RestartOnPull:
        """The first session's tile counts or change: its first pull
        restarts and drains the new session to its end."""

        def __init__(self, t):
            self.t = t

        def cpu(self):
            if "frames" not in inner:
                rti.restart_rendering()
                inner["frames"] = drain(rti)
            return self.t.cpu()

    def restart_on_first_pull(*args):
        acc, counts, change = accumulate_tiled(*args)
        if not inner:
            inner["armed"] = True
            counts, change = RestartOnPull(counts), RestartOnPull(change)
        return acc, counts, change

    monkeypatch.setattr(app_interaction, "accumulate_tiled",
                        restart_on_first_pull)
    rti.settings.update(adaptive_tiles=True, noise_target=1e-30)
    first_queue = rti.frame_queue
    rti.start_rendering()
    t0 = time.time()
    while "frames" not in inner and time.time() - t0 < 60:
        time.sleep(0.02)
    rti.stop_rendering(timeout=60)
    frames = inner["frames"]
    assert frames and frames[-1].get("done")
    shown = [f for f in frames if "display" in f]
    assert [f["samples"] for f in shown] == [2, 4], shown
    assert rti.total_samples == 4
    assert rti._tile_sample_stats == (4, 4, 4)
    assert rti._active_tiles == 1
    # the old worker's own queue got its done frame and no picture
    old = []
    while not first_queue.empty():
        old.append(first_queue.get_nowait())
    assert [f.get("done") for f in old] == [True], old
