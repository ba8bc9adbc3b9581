"""The port's Qt GUI (tpu_rt_torch/app/gui.py), executed against the
behavioral PyQt5 double in tests/pyqt5_stub/ (used as it is), through the
flows of tests/test_gui_qt.py: window construction, the six control tabs,
signal/slot hookup, the RenderThread -> _on_frame fan-out with a real frame
from the port's render worker on the CPU, mode buttons, the material
debounce timer, the camera sync timer, scripted dialogs, key routing and
the close path. Then the missing-Qt path of tests/test_gui_module.py,
with PyQt5 blocked so it runs whether or not Qt is installed.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pyqt5_stub")
GUI_MODULE = "tpu_rt_torch.app.gui"

torch.set_num_threads(1)


def _purge():
    """Remove PyQt5 and the port's gui module from sys.modules; returns
    what was there."""
    return {k: sys.modules.pop(k) for k in list(sys.modules)
            if k.split(".")[0] == "PyQt5" or k == GUI_MODULE}


def _restore(saved):
    _purge()
    sys.modules.update(saved)


@pytest.fixture(scope="module")
def gui_mod():
    """Import the port's gui.py against the stub, restoring modules
    after."""
    saved = _purge()
    sys.path.insert(0, STUB)
    try:
        import tpu_rt_torch.app.gui as gui

        assert gui.HAVE_QT, "stub import failed; gui fell back to headless"
        yield gui
    finally:
        sys.path.remove(STUB)
        _restore(saved)


@pytest.fixture()
def gui(gui_mod):
    g = gui_mod.GUI(64, 48, device="cpu")
    yield g
    g.close()


class _KeyEvent:
    def __init__(self, key, auto=False):
        self._key = key
        self._auto = auto

    def key(self):
        return self._key

    def isAutoRepeat(self):
        return self._auto


class _Pos:
    def __init__(self, x, y):
        self._x, self._y = x, y

    def x(self):
        return self._x

    def y(self):
        return self._y


class _MouseEvent:
    def __init__(self, x, y, button=1):
        self._pos = _Pos(x, y)
        self._button = button

    def pos(self):
        return self._pos

    def button(self):
        return self._button


def test_window_constructs_with_full_widget_tree(gui, gui_mod):
    titles = [gui.control_panel.tabText(i)
              for i in range(gui.control_panel.count())]
    assert titles == ["Render", "Scene", "Camera", "Object", "Material",
                      "Denoiser"]
    dtitles = [gui.display_tabs.tabText(i)
               for i in range(gui.display_tabs.count())]
    assert dtitles == ["Main", "Enhanced", "Denoisers"]
    RM = gui_mod.RenderMode
    assert gui.mode_buttons[RM.RAYTRACING].isChecked()
    assert not gui.mode_buttons[RM.WIREFRAME].isChecked()
    assert "QMainWindow" in gui._stylesheet
    assert gui.statusBar()._widgets == [gui.status_label]
    assert gui.statusBar()._permanent == [gui.progress]
    assert gui.render_thread.isRunning()
    # the session renders where it was asked to
    assert gui.raytracer.device == torch.device("cpu")
    assert gui.raytracer.denoiser.device == torch.device("cpu")


def test_real_frame_flows_through_render_thread_to_displays(gui):
    """render worker -> frame queue -> RenderThread (a real Python thread)
    -> frame_ready -> _on_frame -> QImage on every display, with the
    port's first real frame (64x48, the plain version on the CPU)."""
    deadline = time.time() + 300.0
    while gui.main_display.pixmap() is None and time.time() < deadline:
        time.sleep(0.1)
    pm = gui.main_display.pixmap()
    assert pm is not None, "no frame reached the main display"
    img = pm.image()
    assert (img.width(), img.height()) == (64, 48)
    assert gui.enhanced_display.pixmap() is not None
    assert "Samples" in gui.status_label.text()
    assert gui.progress.value() > 0
    r, g, b = img.pixel_rgb(32, 24)
    assert all(0 <= c <= 255 for c in (r, g, b))


def test_mode_buttons_drive_fsm_and_check_states(gui, gui_mod):
    RM = gui_mod.RenderMode
    gui.mode_buttons[RM.WIREFRAME].click()
    assert gui.raytracer.render_state.current_mode == RM.WIREFRAME
    assert gui.mode_buttons[RM.WIREFRAME].isChecked()
    assert not gui.mode_buttons[RM.RAYTRACING].isChecked()
    gui.mode_buttons[RM.SILHOUETTE].click()
    assert gui.raytracer.render_state.current_mode == RM.SILHOUETTE
    gui.mode_buttons[RM.RAYTRACING].click()
    assert gui.raytracer.render_state.current_mode == RM.RAYTRACING
    assert gui.mode_buttons[RM.RAYTRACING].isChecked()


def test_render_tab_spins_write_settings(gui):
    panel = gui.control_panel
    st = gui.raytracer.settings
    before = st["max_samples"]
    tab0 = panel.widget(0).widget()  # scroll area -> tab widget
    spins = [w for w in tab0.layout().widgets()
             if w.__class__.__name__ in ("QSpinBox", "QDoubleSpinBox")]
    spins[0].setValue(before + 32)
    assert st["max_samples"] == before + 32
    spins[2].setValue(7)
    assert st["max_depth"] == 7


def test_material_sliders_debounce_then_commit(gui):
    panel = gui.control_panel
    rt = gui.raytracer
    obj = rt.get_selected_object()
    assert obj is not None
    panel.rgb_sliders["r"].setValue(10)
    assert abs(obj.material.albedo.x - 0.10) < 1e-6
    assert panel._material_timer.isActive()
    assert panel._material_timer.interval() == 1000
    panel._material_timer.fire()
    assert not panel._material_timer.isActive()
    # the commit reached the tracer's snapshot
    snap = rt.ray_tracer._scene_snapshot.spheres
    assert abs(next(s for s in snap if s.object_id == obj.object_id)
               .material.albedo.x - 0.10) < 1e-6


def test_updating_guard_blocks_reentrant_material_writes(gui):
    panel = gui.control_panel
    panel._material_timer.stop()
    panel.update_material_sliders()
    assert not panel._material_timer.isActive()


def test_camera_sync_timer_reads_back_camera(gui):
    gui.raytracer.camera.position.x = 3.25
    gui.cam_timer.fire()
    assert gui.control_panel.cam_spins[("position", "x")].value() == \
        pytest.approx(3.25)


def test_camera_spin_writes_camera_and_restarts(gui):
    box = gui.control_panel.cam_spins[("position", "y")]
    box.setValue(4.5)
    assert gui.raytracer.camera.position.y == pytest.approx(4.5)
    # the tracer holds the same camera: its params land on its device
    assert gui.raytracer.ray_tracer.camera.to_params().position.device == \
        torch.device("cpu")


def test_scripted_color_dialog_applies_albedo(gui, gui_mod):
    from PyQt5.QtGui import QColor
    from PyQt5.QtWidgets import QColorDialog

    QColorDialog._next_color = QColor(255, 0, 0)
    gui.control_panel._pick_color()
    obj = gui.raytracer.get_selected_object()
    assert obj.material.albedo.x == pytest.approx(1.0, abs=2e-2)
    assert obj.material.albedo.y == pytest.approx(0.0, abs=2e-2)


def test_scripted_file_dialog_loads_obj(gui, tmp_path):
    from PyQt5.QtWidgets import QFileDialog

    obj_path = tmp_path / "tri.obj"
    obj_path.write_text(
        "v 0 0 -3\nv 1 0 -3\nv 0 1 -3\nf 1 2 3\n")
    QFileDialog._next_path = str(obj_path)
    gui.control_panel._load_obj_mesh()
    assert "Loaded 1 triangles" in gui.statusBar().currentMessage()
    assert gui.raytracer.mesh.device == torch.device("cpu")


def test_key_routing_press_release(gui, gui_mod):
    from PyQt5.QtCore import Qt

    gui.keyPressEvent(_KeyEvent(Qt.Key_W))
    assert gui.raytracer.camera_controller.keys_pressed["forward"]
    gui.keyReleaseEvent(_KeyEvent(Qt.Key_W, auto=True))
    assert gui.raytracer.camera_controller.keys_pressed["forward"]
    gui.keyReleaseEvent(_KeyEvent(Qt.Key_W))
    assert not gui.raytracer.camera_controller.keys_pressed["forward"]
    gui.keyPressEvent(_KeyEvent(Qt.Key_A))
    gui.focusOutEvent(None)
    assert not any(gui.raytracer.camera_controller.keys_pressed.values())


def test_mouse_events_route_through_display_signals(gui):
    disp = gui.main_display
    disp.set_image(np.full((48, 64, 3), 0.5, np.float32))
    seen = []
    disp.mouse_pressed.connect(lambda x, y, b: seen.append((x, y, b)))
    disp.mousePressEvent(_MouseEvent(10, 10))
    assert seen, "mousePressEvent did not emit mouse_pressed"
    x, y, _ = seen[0]
    assert 0.0 <= x <= 1.0 and 0.0 <= y <= 1.0
    disp.mouseReleaseEvent(_MouseEvent(10, 10))


def test_image_display_rejects_wrong_stride(gui_mod):
    from PyQt5.QtGui import QImage

    buf = np.zeros((10, 10, 3), np.uint8)
    with pytest.raises(ValueError):
        QImage(buf.data, 20, 10, 60, QImage.Format_RGB888)


def test_denoiser_tab_toggles_methods(gui):
    panel = gui.control_panel
    st = gui.raytracer.settings
    assert "bilateral" in st["selected_denoisers"]
    panel.denoiser_boxes["bilateral"].setChecked(False)
    assert "bilateral" not in st["selected_denoisers"]
    panel.denoiser_boxes["gaussian"].setChecked(True)
    assert "gaussian" in st["selected_denoisers"]


def test_object_combo_selects_and_updates_info(gui):
    panel = gui.control_panel
    combo = panel.object_select
    assert combo.count() > 1
    panel._select_object(1)
    oid = combo.itemData(1)
    if oid is not None:
        assert gui.raytracer.settings["selected_object"] == oid
    assert panel.object_info.text()


def test_close_event_stops_threads(gui_mod):
    g = gui_mod.GUI(64, 48, device="cpu")
    assert g.render_thread.isRunning()
    assert g.close()
    deadline = time.time() + 5
    while g.render_thread.isRunning() and time.time() < deadline:
        time.sleep(0.05)
    assert not g.render_thread.isRunning()
    assert not g.raytracer.render_state.is_rendering


@pytest.fixture()
def no_qt():
    """The port's gui module imported with PyQt5 blocked."""
    saved = _purge()
    sys.modules["PyQt5"] = None
    try:
        import tpu_rt_torch.app.gui as gui

        yield gui
    finally:
        del sys.modules["PyQt5"]
        _restore(saved)


def test_gui_module_imports_without_qt(no_qt):
    assert not no_qt.HAVE_QT
    with pytest.raises(ImportError, match="PyQt5"):
        no_qt.GUI(device="cpu")
    with pytest.raises(ImportError, match="PyQt5"):
        no_qt.main(device="cpu")


def test_launcher_reports_missing_qt(no_qt, capsys):
    from tpu_rt_torch.app import run as app_run

    rc = app_run.main(["--device", "cpu"])  # GUI mode asked, Qt missing
    assert rc == 1
    out = capsys.readouterr().out
    assert "PyQt5" in out and "--headless" in out
