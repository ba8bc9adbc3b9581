"""PyQt5 GUI: window, control tabs, displays, input routing.

Rebuild of the reference's view layer (gui.py, SURVEY.md §2.2 P12-P15) over
the CUDA-backed ``RayTracerInteraction``: a frame-polling render thread, three
display tabs (main / enhanced / denoiser grid), three render-mode buttons,
six control tabs (render, scene, camera, object, material, denoiser), status
bar with sample progress, and WASD/IJKL/XYZ/ESC key routing.

PyQt5 is optional in the environment; importing this module without it
raises only at construction time so the rest of the app layer stays usable
headless. Counterpart of ``tpu_rt/app/gui.py``, the same window; the
session renders on ``device`` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

import numpy as np

try:
    from PyQt5.QtCore import Qt, QThread, QTimer, pyqtSignal
    from PyQt5.QtGui import QColor, QImage, QPixmap
    from PyQt5.QtWidgets import (
        QApplication, QCheckBox, QColorDialog, QComboBox, QDoubleSpinBox,
        QGridLayout, QGroupBox, QHBoxLayout, QLabel, QMainWindow,
        QProgressBar, QPushButton, QScrollArea, QSlider, QSpinBox,
        QTabWidget, QVBoxLayout, QWidget,
    )

    HAVE_QT = True
except ImportError:  # pragma: no cover - headless image
    HAVE_QT = False

    class _Stub:  # minimal placeholders so the module imports cleanly
        pass

    QThread = QMainWindow = _Stub  # type: ignore

from . import panel_logic as PL
from .interaction import RayTracerInteraction, RenderMode

DARK_STYLESHEET = """
QMainWindow, QWidget { background-color: #2b2b2b; color: #dddddd; }
QTabWidget::pane { border: 1px solid #444; }
QTabBar::tab { background: #3c3c3c; color: #ddd; padding: 6px 10px; }
QTabBar::tab:selected { background: #505050; }
QPushButton { background: #454545; border: 1px solid #5a5a5a;
              padding: 5px 10px; border-radius: 3px; }
QPushButton:hover { background: #525252; }
QPushButton:checked { background: #2d6da3; }
QSlider::groove:horizontal { height: 5px; background: #555; }
QSlider::handle:horizontal { width: 14px; background: #2d8cff;
                             margin: -5px 0; border-radius: 7px; }
QProgressBar { border: 1px solid #555; background: #333; text-align: center; }
QProgressBar::chunk { background: #2d6da3; }
QGroupBox { border: 1px solid #4a4a4a; margin-top: 8px; padding-top: 12px; }
"""

# Qt key code -> panel_logic key name (routing itself lives in panel_logic)
_KEY_NAMES = {}
if HAVE_QT:
    _KEY_NAMES = {
        Qt.Key_W: "w", Qt.Key_S: "s", Qt.Key_A: "a", Qt.Key_D: "d",
        Qt.Key_Space: "space", Qt.Key_Control: "ctrl",
        Qt.Key_I: "i", Qt.Key_K: "k", Qt.Key_J: "j", Qt.Key_L: "l",
        Qt.Key_U: "u", Qt.Key_O: "o",
        Qt.Key_X: "x", Qt.Key_Y: "y", Qt.Key_Z: "z",
        Qt.Key_Escape: "escape",
    }


class RenderThread(QThread):
    """Frame-queue poller (reference RenderThread, gui.py:14-46)."""

    if HAVE_QT:
        frame_ready = pyqtSignal(dict)
        rendering_finished = pyqtSignal()

    def __init__(self, raytracer: RayTracerInteraction):
        super().__init__()
        self.raytracer = raytracer
        self.running = True

    def run(self):
        self.raytracer.start_rendering()
        while self.running:
            while self.raytracer.has_frames():
                frame = self.raytracer.get_frame()
                if frame is None:
                    break
                if frame.get("done"):
                    self.rendering_finished.emit()
                else:
                    self.frame_ready.emit(frame)
            self.msleep(16)

    def stop(self):
        self.running = False
        self.wait(1000)


class ImageDisplay(QLabel if HAVE_QT else object):
    """Float-image display with normalized mouse signals
    (reference ImageDisplay, gui.py:48-123)."""

    if HAVE_QT:
        mouse_pressed = pyqtSignal(float, float, object)
        mouse_moved = pyqtSignal(float, float)
        mouse_released = pyqtSignal()

    def __init__(self):
        super().__init__()
        self.setMinimumSize(320, 240)
        self.setAlignment(Qt.AlignCenter)
        self.setMouseTracking(True)
        self._last = None

    def set_image(self, image: np.ndarray):
        u8 = PL.to_uint8(image)
        h, w, _ = u8.shape
        qimg = QImage(u8.data, w, h, 3 * w, QImage.Format_RGB888)
        self._last = u8  # keep buffer alive
        self.setPixmap(QPixmap.fromImage(qimg).scaled(
            self.size(), Qt.KeepAspectRatio, Qt.SmoothTransformation))

    def _norm(self, event):
        pm = self.pixmap()
        if pm is None:
            return None
        return PL.normalize_mouse(event.pos().x(), event.pos().y(),
                                  self.width(), self.height(),
                                  pm.width(), pm.height())

    def mousePressEvent(self, event):
        p = self._norm(event)
        if p:
            self.mouse_pressed.emit(p[0], p[1], event.button())

    def mouseMoveEvent(self, event):
        p = self._norm(event)
        if p:
            self.mouse_moved.emit(p[0], p[1])

    def mouseReleaseEvent(self, event):
        self.mouse_released.emit()


class ControlPanel(QTabWidget if HAVE_QT else object):
    """Six control tabs (reference ScrollableTabbedControlPanel,
    gui.py:125-1186)."""

    def __init__(self, rt: RayTracerInteraction, gui):
        super().__init__()
        self.rt = rt
        self.gui = gui
        self._updating = False
        # 1 s debounce for material sliders (gui.py:130-133)
        self._material_timer = QTimer()
        self._material_timer.setSingleShot(True)
        self._material_timer.timeout.connect(self._commit_material)
        self._build_render_tab()
        self._build_scene_tab()
        self._build_camera_tab()
        self._build_object_tab()
        self._build_material_tab()
        self._build_denoiser_tab()
        self.update_object_list()

    # -- helpers ----------------------------------------------------------
    def _tab(self, title):
        w = QWidget()
        lay = QVBoxLayout(w)
        scroll = QScrollArea()
        scroll.setWidget(w)
        scroll.setWidgetResizable(True)
        self.addTab(scroll, title)
        return lay

    def _spin(self, lay, label, lo, hi, value, on_change, double=False,
              step=None):
        row = QHBoxLayout()
        row.addWidget(QLabel(label))
        box = QDoubleSpinBox() if double else QSpinBox()
        box.setRange(lo, hi)
        if step:
            box.setSingleStep(step)
        box.setValue(value)
        box.valueChanged.connect(on_change)
        row.addWidget(box)
        lay.addLayout(row)
        return box

    def _slider(self, lay, label, lo, hi, value, on_change):
        row = QHBoxLayout()
        row.addWidget(QLabel(label))
        s = QSlider(Qt.Horizontal)
        s.setRange(lo, hi)
        s.setValue(value)
        s.valueChanged.connect(on_change)
        row.addWidget(s)
        lay.addLayout(row)
        return s

    # -- render tab (gui.py:167-245) ---------------------------------------
    def _build_render_tab(self):
        lay = self._tab("Render")
        st = self.rt.settings
        self._spin(lay, "Max Samples", 1, 1024, st["max_samples"],
                   lambda v: self._set("max_samples", v))
        self._spin(lay, "Samples/Batch", 1, 64, st["samples_per_batch"],
                   lambda v: self._set("samples_per_batch", v))
        self._spin(lay, "Max Depth", 1, 32, st["max_depth"],
                   lambda v: self._set("max_depth", v))
        self._spin(lay, "Exposure", 0.1, 5.0, st["exposure"],
                   lambda v: self._set("exposure", v), double=True, step=0.1)
        enhance = QCheckBox("Enhance Image")
        enhance.setChecked(st["enhance_image"])
        enhance.toggled.connect(lambda b: self._set("enhance_image", b))
        lay.addWidget(enhance)
        # beyond-reference estimator toggle (utils/config.py `nee`)
        nee = QCheckBox("Direct Light Sampling (NEE)")
        nee.setChecked(bool(st.get("nee", False)))
        nee.toggled.connect(lambda b: self._set("nee", b))
        lay.addWidget(nee)
        # beyond-reference sampler toggle (utils/config.py `stratify`)
        strat = QCheckBox("Stratified Sampling (R2)")
        strat.setChecked(bool(st.get("stratify", False)))
        strat.toggled.connect(lambda b: self._set("stratify", b))
        lay.addWidget(strat)
        # beyond-reference convergence controls: auto-stop target and
        # per-tile adaptive sampling (app/interaction.py:_render_worker)
        self._spin(lay, "Noise Target (0=off)", 0.0, 0.2,
                   float(st.get("noise_target", 0.0)),
                   lambda v: self._set("noise_target", v), double=True,
                   step=0.005)
        adap = QCheckBox("Adaptive Tile Sampling")
        adap.setChecked(bool(st.get("adaptive_tiles", False)))
        adap.toggled.connect(lambda b: self._set("adaptive_tiles", b))
        lay.addWidget(adap)
        res = QHBoxLayout()
        self.res_w = QSpinBox(); self.res_w.setRange(64, 3840)
        self.res_w.setValue(self.rt.width)
        self.res_h = QSpinBox(); self.res_h.setRange(64, 2160)
        self.res_h.setValue(self.rt.height)
        apply_btn = QPushButton("Apply Resolution")
        apply_btn.clicked.connect(
            lambda: self.rt.resize_viewport(self.res_w.value(),
                                            self.res_h.value()))
        res.addWidget(QLabel("W")); res.addWidget(self.res_w)
        res.addWidget(QLabel("H")); res.addWidget(self.res_h)
        res.addWidget(apply_btn)
        lay.addLayout(res)
        lay.addStretch()

    def _set(self, key, value):
        PL.set_setting(self.rt, key, value)

    # -- scene tab (gui.py:247-325) -----------------------------------------
    def _build_scene_tab(self):
        lay = self._tab("Scene")
        add = QPushButton("Add Sphere")
        add.clicked.connect(self.rt.add_object_to_scene)
        rem = QPushButton("Remove Selected")
        rem.clicked.connect(lambda: self.rt.remove_object_from_scene(
            self.rt.settings["selected_object"]))
        lay.addWidget(add)
        lay.addWidget(rem)

        load_obj = QPushButton("Load OBJ Mesh...")
        load_obj.clicked.connect(self._load_obj_mesh)
        clear_obj = QPushButton("Clear Mesh")
        clear_obj.clicked.connect(lambda: self.rt.set_mesh(None))
        lay.addWidget(load_obj)
        lay.addWidget(clear_obj)

        grp = QGroupBox("Procedural Texture")
        g = QVBoxLayout(grp)
        self.texture_type = QComboBox()
        self.texture_type.addItems(["none", "noise"])
        g.addWidget(self.texture_type)
        self.tex_scale = self._spin(g, "Scale", 0.1, 20.0, 1.0,
                                    lambda v: None, double=True, step=0.1)
        self.tex_octaves = self._spin(g, "Octaves", 1, 8, 3, lambda v: None)
        self.tex_h = self._slider(g, "Tint H", 0, 360, 0, lambda v: None)
        self.tex_s = self._slider(g, "Tint S", 0, 100, 0, lambda v: None)
        self.tex_v = self._slider(g, "Tint V", 0, 100, 100, lambda v: None)
        apply_tex = QPushButton("Apply Texture")
        apply_tex.clicked.connect(self._apply_texture)
        g.addWidget(apply_tex)
        lay.addWidget(grp)
        lay.addStretch()

    def _load_obj_mesh(self):
        """File-dialog OBJ import onto the live session (beyond-reference:
        the reference has no asset pipeline; tpu_rt_torch.utils.objio)."""
        from PyQt5.QtWidgets import QFileDialog

        path, _ = QFileDialog.getOpenFileName(
            self, "Load OBJ mesh", "", "Wavefront OBJ (*.obj)")
        if path:
            try:
                n = self.rt.load_mesh_from_obj(path)
                self.gui.statusBar().showMessage(
                    f"Loaded {n} triangles from {path}", 5000)
            except Exception as e:  # surface parse errors, don't crash the UI
                self.gui.statusBar().showMessage(f"OBJ load failed: {e}", 8000)

    def _apply_texture(self):
        params = PL.texture_params(
            self.tex_scale.value(), self.tex_octaves.value(),
            self.tex_h.value(), self.tex_s.value(), self.tex_v.value())
        self.rt.set_object_texture(self.texture_type.currentText(), params)

    # -- camera tab (gui.py:327-459) ------------------------------------------
    def _build_camera_tab(self):
        lay = self._tab("Camera")
        cam = self.rt.camera
        self.cam_spins = {}
        for label, obj in (("Position", "position"), ("Target", "target")):
            grp = QGroupBox(label)
            g = QHBoxLayout(grp)
            for axis in "xyz":
                box = QDoubleSpinBox()
                box.setRange(-20, 20)
                box.setSingleStep(0.1)
                box.setValue(getattr(getattr(cam, obj), axis))
                box.valueChanged.connect(
                    lambda v, o=obj, a=axis: self._set_camera(o, a, v))
                g.addWidget(QLabel(axis.upper()))
                g.addWidget(box)
                self.cam_spins[(obj, axis)] = box
            lay.addWidget(grp)
        self.fov_spin = self._spin(lay, "FOV", 10, 120, int(cam.fov),
                                   self._set_fov)
        self._spin(lay, "Move Speed", 0.01, 1.0,
                   self.rt.settings["camera_move_speed"],
                   lambda v: self._set("camera_move_speed", v),
                   double=True, step=0.01)
        self._spin(lay, "Rotate Speed", 0.05, 2.0,
                   self.rt.settings["camera_rotate_speed"],
                   lambda v: self._set("camera_rotate_speed", v),
                   double=True, step=0.05)
        self._spin(lay, "Aperture (DOF)", 0.0, 2.0,
                   getattr(cam, "aperture", 0.0),
                   lambda v: self._set_lens("aperture", v),
                   double=True, step=0.01)
        self._spin(lay, "Focus Dist (0 = target)", 0.0, 50.0,
                   getattr(cam, "focus_dist", 0.0),
                   lambda v: self._set_lens("focus_dist", v),
                   double=True, step=0.1)
        reset = QPushButton("Reset Camera")
        reset.clicked.connect(self.rt.reset_camera_and_rerender)
        lay.addWidget(reset)
        lay.addStretch()

    def _set_lens(self, field, value):
        if self._updating:
            return
        setattr(self.rt.camera, field, float(value))
        self.rt.ray_tracer.set_camera(self.rt.camera)
        self.rt.restart_rendering()

    def _set_camera(self, obj, axis, value):
        if self._updating:
            return
        setattr(getattr(self.rt.camera, obj), axis, value)
        self.rt.ray_tracer.set_camera(self.rt.camera)
        self.rt.restart_rendering()

    def _set_fov(self, value):
        if self._updating:
            return
        self.rt.camera.fov = float(value)
        self.rt.ray_tracer.set_camera(self.rt.camera)
        self.rt.restart_rendering()

    def sync_camera_panel(self):
        """100 ms camera readback (gui.py:1230-1232)."""
        self._updating = True
        try:
            for (obj, axis), box in self.cam_spins.items():
                box.setValue(getattr(getattr(self.rt.camera, obj), axis))
        finally:
            self._updating = False

    # -- object tab (gui.py:461-554) -------------------------------------------
    def _build_object_tab(self):
        lay = self._tab("Object")
        self.object_select = QComboBox()
        self.object_select.currentIndexChanged.connect(self._select_object)
        lay.addWidget(self.object_select)
        self.object_info = QLabel("")
        lay.addWidget(self.object_info)

        grid = QGridLayout()
        moves = [("I (-z)", (0, 0, -1), 0, 1), ("K (+z)", (0, 0, 1), 2, 1),
                 ("J (-x)", (-1, 0, 0), 1, 0), ("L (+x)", (1, 0, 0), 1, 2),
                 ("U (+y)", (0, 1, 0), 0, 2), ("O (-y)", (0, -1, 0), 2, 2)]
        for label, delta, r, c in moves:
            b = QPushButton(label)
            b.clicked.connect(lambda _, d=delta: self.rt.move_object(*d))
            grid.addWidget(b, r, c)
        lay.addLayout(grid)

        self._spin(lay, "Move Speed", 0.05, 2.0, self.rt.settings["move_speed"],
                   lambda v: self._set("move_speed", v), double=True, step=0.05)
        locks = QHBoxLayout()
        self.lock_boxes = {}
        for axis in "xyz":
            cb = QCheckBox(f"Lock {axis.upper()}")
            cb.toggled.connect(
                lambda b, a=axis: self.rt.set_dimension_lock(a, b))
            locks.addWidget(cb)
            self.lock_boxes[axis] = cb
        lay.addLayout(locks)
        lay.addStretch()

    def _select_object(self, index):
        if self._updating or index < 0:
            return
        oid = self.object_select.itemData(index)
        if oid is None:
            return
        PL.select_object(self.rt, oid)
        self.update_object_info()
        self.update_material_sliders()

    def update_object_list(self):
        self._updating = True
        try:
            self.object_select.clear()
            entries, current = PL.object_list_entries(self.rt)
            for label, oid in entries:
                self.object_select.addItem(label, oid)
            if current >= 0:
                self.object_select.setCurrentIndex(current)
        finally:
            self._updating = False
        self.update_object_info()

    def update_object_info(self):
        self.object_info.setText(
            PL.object_info_text(self.rt.get_selected_object()))

    # -- material tab (gui.py:556-917) --------------------------------------------
    def _build_material_tab(self):
        lay = self._tab("Material")
        self.rgb_sliders = {}
        for ch in "rgb":
            self.rgb_sliders[ch] = self._slider(
                lay, ch.upper(), 0, 100, 80,
                lambda v, c=ch: self._material_changed())
        pick = QPushButton("Pick Color...")
        pick.clicked.connect(self._pick_color)
        lay.addWidget(pick)
        self.hsv_sliders = {}
        for ch, hi in (("h", 360), ("s", 100), ("v", 100)):
            self.hsv_sliders[ch] = self._slider(
                lay, ch.upper(), 0, hi, 0,
                lambda v, c=ch: self._hsv_changed())
        self.metallic_slider = self._slider(
            lay, "Metallic", 0, 100, 0, lambda v: self._material_changed())
        self.roughness_slider = self._slider(
            lay, "Roughness", 0, 100, 50, lambda v: self._material_changed())
        self.light_power = self._spin(
            lay, "Light Power", 0.1, 100.0, 10.0,
            lambda v: self.rt.update_light_intensity(v), double=True, step=0.5)
        lay.addStretch()

    def _pick_color(self):
        obj = self.rt.get_selected_object()
        if obj is None:
            return
        a = obj.material.albedo
        initial = QColor(int(a.x * 255), int(a.y * 255), int(a.z * 255))
        color = QColorDialog.getColor(initial)
        if color.isValid():
            self.rt.set_object_color(color.redF(), color.greenF(),
                                     color.blueF())
            self.update_material_sliders()

    def _material_changed(self):
        if self._updating:
            return
        obj = self.rt.get_selected_object()
        if obj is None:
            return
        PL.apply_material_sliders(
            obj, self.rgb_sliders["r"].value(), self.rgb_sliders["g"].value(),
            self.rgb_sliders["b"].value(), self.metallic_slider.value(),
            self.roughness_slider.value())
        self._material_timer.start(1000)  # debounce (gui.py:130-133)

    def _hsv_changed(self):
        if self._updating:
            return
        self.rt.set_object_color_hsv(self.hsv_sliders["h"].value(),
                                     self.hsv_sliders["s"].value() / 100.0,
                                     self.hsv_sliders["v"].value() / 100.0,
                                     apply_immediate=False)
        self.update_material_sliders(skip_hsv=True)
        self._material_timer.start(1000)

    def _commit_material(self):
        self.rt.update_object_material_immediate()

    def update_material_sliders(self, skip_hsv=False):
        vals = PL.material_slider_values(self.rt.get_selected_object())
        if vals is None:
            return
        self._updating = True
        try:
            for ch in "rgb":
                self.rgb_sliders[ch].setValue(vals[ch])
            self.metallic_slider.setValue(vals["metallic"])
            self.roughness_slider.setValue(vals["roughness"])
            if "light_power" in vals:
                self.light_power.setValue(vals["light_power"])
        finally:
            self._updating = False

    # -- denoiser tab (gui.py:691-734) -----------------------------------------
    def _build_denoiser_tab(self):
        lay = self._tab("Denoiser")
        show = QCheckBox("Show Denoisers")
        show.setChecked(self.rt.settings["show_denoisers"])
        show.toggled.connect(lambda b: self._set_denoiser_show(b))
        lay.addWidget(show)
        self.denoiser_boxes = {}
        for m in self.rt.denoiser.available_methods:
            cb = QCheckBox(m)
            cb.setChecked(m in self.rt.settings["selected_denoisers"])
            cb.toggled.connect(lambda b, mm=m: self._toggle_denoiser(mm, b))
            lay.addWidget(cb)
            self.denoiser_boxes[m] = cb
        lay.addStretch()

    def _set_denoiser_show(self, enabled):
        self.rt.settings["show_denoisers"] = enabled

    def _toggle_denoiser(self, method, enabled):
        PL.toggle_denoiser(self.rt.settings, method, enabled)


class GUI(QMainWindow if HAVE_QT else object):
    """Main window (reference GUI, gui.py:1188-1858)."""

    def __init__(self, width: int = 640, height: int = 480, *,
                 device="cuda"):
        if not HAVE_QT:
            raise ImportError(
                "PyQt5 is not installed; use the headless runtime "
                "(tpu_rt_torch.app.RayTracerInteraction) or "
                "tpu_rt_torch.app.run --headless instead.")
        super().__init__()
        self.setWindowTitle("tpu-rt — CUDA Path Tracer")
        self.raytracer = RayTracerInteraction(width, height, device=device)
        self.raytracer._gui = self
        self._build_ui()
        self.setStyleSheet(DARK_STYLESHEET)
        self._start_threads()

    # -- layout --------------------------------------------------------------
    def _build_ui(self):
        central = QWidget()
        self.setCentralWidget(central)
        root = QHBoxLayout(central)

        # display tabs: main / enhanced / denoiser grid (gui.py:1446-1499)
        self.display_tabs = QTabWidget()
        self.main_display = ImageDisplay()
        self.enhanced_display = ImageDisplay()
        self.display_tabs.addTab(self.main_display, "Main")
        self.display_tabs.addTab(self.enhanced_display, "Enhanced")
        grid_widget = QWidget()
        grid = QGridLayout(grid_widget)
        self.denoiser_displays = {}
        for i, m in enumerate(["bilateral", "nlmeans", "gaussian", "median"]):
            box = QVBoxLayout()
            box.addWidget(QLabel(m))
            disp = ImageDisplay()
            box.addWidget(disp)
            w = QWidget()
            w.setLayout(box)
            grid.addWidget(w, i // 2, i % 2)
            self.denoiser_displays[m] = disp
        self.display_tabs.addTab(grid_widget, "Denoisers")

        left = QVBoxLayout()
        # mode buttons (gui.py:1416-1444)
        modes = QHBoxLayout()
        self.mode_buttons = {}
        for label, mode in (("Ray Tracing", RenderMode.RAYTRACING),
                            ("Wireframe", RenderMode.WIREFRAME),
                            ("Silhouette", RenderMode.SILHOUETTE)):
            b = QPushButton(label)
            b.setCheckable(True)
            b.clicked.connect(lambda _, m=mode: self._set_mode(m))
            modes.addWidget(b)
            self.mode_buttons[mode] = b
        self.mode_buttons[RenderMode.RAYTRACING].setChecked(True)
        left.addLayout(modes)
        left.addWidget(self.display_tabs, stretch=1)
        root.addLayout(left, stretch=3)

        self.control_panel = ControlPanel(self.raytracer, self)
        root.addWidget(self.control_panel, stretch=1)

        # status bar (gui.py:1266-1282)
        self.status_label = QLabel("Samples: 0")
        self.progress = QProgressBar()
        self.statusBar().addWidget(self.status_label, 1)
        self.statusBar().addPermanentWidget(self.progress)

        # mouse routing (gui.py:1655-1727) — state machine lives headless
        for disp in (self.main_display, self.enhanced_display):
            disp.mouse_pressed.connect(self._on_mouse_press)
            disp.mouse_moved.connect(self._on_mouse_move)
            disp.mouse_released.connect(self._on_mouse_release)
        self._mouse = PL.MouseRouter(self.raytracer)

        # 100 ms camera panel sync (gui.py:1230-1232)
        self.cam_timer = QTimer(self)
        self.cam_timer.timeout.connect(self.control_panel.sync_camera_panel)
        self.cam_timer.start(100)

    def _start_threads(self):
        self.render_thread = RenderThread(self.raytracer)
        self.render_thread.frame_ready.connect(self._on_frame)
        self.render_thread.rendering_finished.connect(
            lambda: self.status_label.setText(
                self.status_label.text() + "  (done)"))
        self.render_thread.start()

    # -- frame updates (gui.py:1610-1648) -----------------------------------
    def _on_frame(self, frame: dict):
        self.main_display.set_image(frame["display"])
        self.enhanced_display.set_image(frame["enhanced"])
        for m, img in frame.get("denoised", {}).items():
            if m in self.denoiser_displays:
                self.denoiser_displays[m].set_image(img)
        text, pct = PL.format_status(
            frame, self.raytracer.settings["max_samples"])
        self.status_label.setText(text)
        if frame.get("is_raytracing"):
            self.progress.setValue(pct)

    # -- modes ----------------------------------------------------------------
    def _set_mode(self, mode: RenderMode):
        for m, b in self.mode_buttons.items():
            b.setChecked(m == mode)
        self.raytracer.render_state.set_mode(mode)
        if mode == RenderMode.RAYTRACING:
            self.raytracer.restart_rendering()
        else:
            self.raytracer._process_frame_for_display(0.016)

    # -- mouse (gui.py:1655-1727) ----------------------------------------------
    def _on_mouse_press(self, x, y, button):
        self._mouse.press(x, y,
                          "right" if button == Qt.RightButton else "left")

    def _on_mouse_move(self, x, y):
        self._mouse.move(x, y)

    def _on_mouse_release(self):
        self._mouse.release()

    # -- keyboard (gui.py:1729-1807) ---------------------------------------------
    def keyPressEvent(self, event):
        if event.isAutoRepeat():
            return
        name = _KEY_NAMES.get(event.key())
        if name:
            PL.route_key(self.raytracer, name, True)

    def keyReleaseEvent(self, event):
        if event.isAutoRepeat():
            return
        name = _KEY_NAMES.get(event.key())
        if name:
            PL.route_key(self.raytracer, name, False)

    def focusOutEvent(self, event):
        # clear key state on focus loss (gui.py:1810-1820)
        PL.clear_camera_keys(self.raytracer)

    def closeEvent(self, event):
        self.render_thread.stop()
        self.raytracer.stop_rendering()
        event.accept()


def main(width: int = 640, height: int = 480, device="cuda") -> int:
    """Start the Qt event loop (reference run.py:110-132)."""
    import sys

    if not HAVE_QT:
        raise ImportError("PyQt5 is not installed")
    app = QApplication(sys.argv)
    gui = GUI(width, height, device=device)
    gui.resize(1200, 700)
    gui.show()
    return app.exec_()
