"""The port's GUI logic without Qt (tpu_rt_torch.app.panel_logic) and its
preview rasterizers (tpu_rt_torch.app.preview), against the JAX package's.

Every flow of tests/test_panel_logic.py runs on the port's runtime on the
CPU; the pure functions and the silhouette and wireframe previews give
what ``tpu_rt``'s give on the same inputs, value for value.
"""

import numpy as np
import pytest
import torch

import tpu_rt.api as J
import tpu_rt.app.interaction as JI
from tpu_rt.app import panel_logic as JPL
from tpu_rt.app import preview as JPV

from tpu_rt_torch.api import Camera, Vector3
from tpu_rt_torch.app import RayTracerInteraction, RenderMode
from tpu_rt_torch.app import panel_logic as PL
from tpu_rt_torch.app import preview as PV
from tpu_rt_torch.app.interaction import SceneManager

torch.set_num_threads(1)


@pytest.fixture
def rti():
    r = RayTracerInteraction(48, 36, device="cpu")
    r.settings["max_samples"] = 4
    r.settings["samples_per_batch"] = 2
    r.settings["max_depth"] = 2
    yield r
    r.stop_rendering()


# -- key routing --------------------------------------------------------

def test_camera_key_press_release(rti):
    assert PL.route_key(rti, "w", True)
    assert rti.camera_controller.keys_pressed["forward"]
    assert rti.render_state.current_mode == RenderMode.WIREFRAME
    assert PL.route_key(rti, "w", False)
    assert not rti.camera_controller.keys_pressed["forward"]


def test_object_key_moves_selected_only_on_press(rti):
    obj = rti.get_selected_object()
    z0 = obj.center.z
    assert PL.route_key(rti, "i", True)
    assert rti.get_selected_object().center.z < z0
    z1 = rti.get_selected_object().center.z
    assert PL.route_key(rti, "i", False)  # release: no move
    assert rti.get_selected_object().center.z == z1


def test_dimension_lock_keys(rti):
    PL.route_key(rti, "x", True)
    assert rti.object_dragger.lock_x
    PL.route_key(rti, "x", False)
    assert not rti.object_dragger.lock_x


def test_unknown_key_not_consumed(rti):
    assert not PL.route_key(rti, "q", True)
    assert PL.CAMERA_KEYS == JPL.CAMERA_KEYS


def test_clear_camera_keys_on_focus_loss(rti):
    PL.route_key(rti, "w", True)
    PL.route_key(rti, "a", True)
    PL.clear_camera_keys(rti)
    assert not any(rti.camera_controller.keys_pressed.values())


# -- mouse state machine -------------------------------------------------

def test_mouse_right_button_rotates_camera(rti):
    m = PL.MouseRouter(rti)
    t0 = (rti.camera.target.x, rti.camera.target.y, rti.camera.target.z)
    m.press(0.5, 0.5, "right")
    assert m.rotating
    m.move(0.6, 0.5)
    m.release()
    assert not m.rotating
    t1 = (rti.camera.target.x, rti.camera.target.y, rti.camera.target.z)
    assert t0 != t1  # camera look direction changed


def test_mouse_left_with_lock_drags_object(rti):
    rti.set_dimension_lock("x", True)
    hit_at = None
    for yy in (0.3, 0.4, 0.5):
        for xx in (0.3, 0.4, 0.5, 0.6, 0.7):
            if rti.select_object_by_click(xx, yy) and \
                    rti.settings["selected_object"] != 0:
                hit_at = (xx, yy)
                break
        if hit_at:
            break
    assert hit_at is not None, "no sphere under any probe point"
    obj = rti.get_selected_object()
    m = PL.MouseRouter(rti)
    m.press(*hit_at, "left")
    assert m.dragging
    x0 = obj.center.x
    m.move(hit_at[0] + 0.05, hit_at[1])
    m.release()
    assert not m.dragging
    # lock_x zeroes x motion; y/z unlocked -> x unchanged
    assert rti.get_selected_object().center.x == x0


def test_mouse_left_without_lock_selects(rti):
    m = PL.MouseRouter(rti)
    m.press(0.5, 0.5, "left")
    assert not m.dragging  # selection path, not dragging
    m.release()


# -- pure functions, against the JAX package's ---------------------------

@pytest.mark.parametrize("args", [
    (100, 50, 200, 100, 100, 100), (50, 0, 200, 100, 100, 100),
    (10, 50, 200, 100, 100, 100), (37, 81, 90, 120, 64, 48),
    (0, 0, 0, 0, 0, 0)])
def test_normalize_mouse_equals_jax(args):
    assert PL.normalize_mouse(*args) == JPL.normalize_mouse(*args)


def test_normalize_mouse_letterboxing():
    assert PL.normalize_mouse(100, 50, 200, 100, 100, 100) == (0.5, 0.5)
    assert PL.normalize_mouse(50, 0, 200, 100, 100, 100) == (0.0, 0.0)
    assert PL.normalize_mouse(10, 50, 200, 100, 100, 100) is None  # in bar


def test_to_uint8_equals_jax():
    img = np.random.default_rng(3).uniform(-0.5, 1.5, (17, 23, 3)).astype(
        np.float32)
    u8 = PL.to_uint8(img)
    assert u8.dtype == np.uint8 and u8.flags["C_CONTIGUOUS"]
    assert np.array_equal(u8, JPL.to_uint8(img))
    assert list(PL.to_uint8(np.array([[[0.0, 0.5, 2.0]]], np.float32))[0, 0]
                ) == [0, 127, 255]


@pytest.mark.parametrize("frame", [
    {"is_raytracing": True, "samples": 8, "render_time": 0.125,
     "mode": "raytracing"},
    {"is_raytracing": True, "samples": 32, "render_time": 0.125,
     "mode": "raytracing", "active_tiles": 5, "n_tiles": 20,
     "tile_samples": (8, 16, 32)},
    {"mode": "wireframe"}])
def test_format_status_equals_jax(frame):
    text, pct = PL.format_status(frame, 32)
    assert (text, pct) == JPL.format_status(frame, 32)
    if frame.get("active_tiles"):
        assert "Tiles: 5/20 active" in text and pct == 100
    elif frame.get("is_raytracing"):
        assert text == "Samples: 8/32 | Batch: 0.125s | Mode: raytracing"


def test_texture_params_and_toggles_equal_jax():
    for args in ((1.0, 3, 120, 0, 100), (2.0, 4, 120, 50, 80)):
        assert PL.texture_params(*args) == JPL.texture_params(*args)
    ours = {"selected_denoisers": ["bilateral"]}
    theirs = {"selected_denoisers": ["bilateral"]}
    for m, on in (("median", True), ("median", True), ("bilateral", False),
                  ("nlmeans", True)):
        PL.toggle_denoiser(ours, m, on)
        JPL.toggle_denoiser(theirs, m, on)
        assert ours == theirs
    assert ours["selected_denoisers"] == ["median", "nlmeans"]


# -- object and material tabs ----------------------------------------------

def test_object_list_entries_and_selection(rti):
    entries, current = PL.object_list_entries(rti)
    assert len(entries) == len(rti.scene.spheres)
    assert entries[current][1] == rti.settings["selected_object"]
    other = entries[(current + 1) % len(entries)][1]
    PL.select_object(rti, other)
    assert rti.settings["selected_object"] == other
    assert rti.object_dragger.selected_object_id == other


def test_object_texts_and_sliders_equal_jax(rti):
    j_scene = JI.SceneManager.create_interactive_scene()
    assert PL.object_info_text(None) == "none"
    assert PL.material_slider_values(None) is None
    for s, js in zip(rti.scene.spheres, j_scene.spheres):
        assert PL.object_info_text(s) == JPL.object_info_text(js)
        assert PL.material_slider_values(s) == JPL.material_slider_values(js)
    obj = rti.get_selected_object()
    PL.apply_material_sliders(obj, 25, 50, 75, 60, 40)
    vals = PL.material_slider_values(obj)
    assert (vals["r"], vals["g"], vals["b"]) == (25, 50, 75)
    assert vals["metallic"] == 60 and vals["roughness"] == 40
    assert "light_power" not in vals  # not emissive
    PL.select_object(rti, 6)  # Main Light (10,10,8)
    assert PL.material_slider_values(
        rti.get_selected_object()).get("light_power") == 10.0


def test_set_setting_restarts_render_for_hot_keys(rti):
    rti.total_samples = 7  # pretend some accumulation happened
    PL.set_setting(rti, "max_depth", 3)  # render-affecting -> restart
    assert rti.settings["max_depth"] == 3
    assert rti.total_samples == 0
    rti.total_samples = 7
    PL.set_setting(rti, "show_denoisers", True)  # cosmetic -> no restart
    assert rti.settings["show_denoisers"] is True
    assert rti.total_samples == 7


# -- preview rasterizers ---------------------------------------------------

def posed_cameras(seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-3, 3, 3) + np.array([0.0, 2.5, 5.0])
    t = rng.uniform(-1, 1, 3) + np.array([0.0, 0.5, -2.0])
    fov = float(rng.uniform(35, 70))
    out = []
    for C, V in ((Camera, Vector3), (J.Camera, J.Vector3)):
        c = C()
        c.position, c.target, c.fov = V(*p), V(*t), fov
        out.append(c)
    return out


@pytest.mark.parametrize("size", [(48, 36), (320, 240)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_previews_equal_jax(size, seed):
    cam, jcam = posed_cameras(seed)
    scene = SceneManager.create_interactive_scene()
    j_scene = JI.SceneManager.create_interactive_scene()
    ours = PV.PreviewRenderer(*size, cam, scene)
    theirs = JPV.PreviewRenderer(*size, jcam, j_scene)
    for sel in (-1, 1, 6):
        a, b = ours.render_silhouette(sel), theirs.render_silhouette(sel)
        assert a.shape == (size[1], size[0], 3) and np.array_equal(a, b)
        a, b = ours.render_wireframe(sel), theirs.render_wireframe(sel)
        assert np.array_equal(a, b) and a.sum() > 0


def test_draw_primitives_equal_jax():
    a = np.zeros((40, 50, 3), np.float32)
    b = a.copy()
    for buf, mod in ((a, PV), (b, JPV)):
        mod.draw_line(buf, (2, 3), (45, 31), (1.0, 0.5, 0.0), thickness=3)
        mod.draw_circle(buf, (25, 20), 9, (0.0, 1.0, 1.0))
    assert np.array_equal(a, b) and a.sum() > 0


def test_previews_draw_content(rti):
    sil = rti.renderer.render_silhouette(1)
    wf = rti.renderer.render_wireframe(1)
    assert sil.sum() > 0 and wf.sum() > 0
    assert wf.sum() > sil.sum()  # the grid
    cyan = (sil[..., 1] > 0.9) & (sil[..., 2] > 0.9) & (sil[..., 0] < 0.1)
    assert cyan.any()
