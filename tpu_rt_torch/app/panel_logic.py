"""Headless GUI logic: everything gui.py does that isn't a Qt widget.

The reference buries this logic inside Qt handlers (gui.py:125-1858), which
makes it untestable without a display. Here the value plumbing, input
routing and state machines live in plain functions/classes operating on the
``RayTracerInteraction`` facade; ``tpu_rt_torch.app.gui`` is a thin Qt
shell over them. A copy of ``tpu_rt/app/panel_logic.py``, held equal to it
in tests/test_torch_panel_logic.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# key name -> camera direction (reference gui.py:1729-1795)
CAMERA_KEYS = {
    "w": "forward", "s": "backward", "a": "left",
    "d": "right", "space": "up", "ctrl": "down",
}
# key name -> object move delta (IJKL/UO)
OBJECT_KEYS = {
    "i": (0, 0, -1), "k": (0, 0, 1), "j": (-1, 0, 0),
    "l": (1, 0, 0), "u": (0, 1, 0), "o": (0, -1, 0),
}
DIMENSION_KEYS = ("x", "y", "z")


def route_key(rt, key: str, pressed: bool) -> bool:
    """Dispatch one (already-name-mapped) key event to the runtime.

    Returns True when the key was consumed. Mirrors the reference's
    keyPressEvent/keyReleaseEvent routing (gui.py:1729-1807): WASD+Space/Ctrl
    drive the camera on press AND release, IJKL/UO nudge the selected object
    on press only, X/Y/Z hold dimension locks, ESC cancels a drag.
    """
    if key in CAMERA_KEYS:
        rt.set_camera_key_state(CAMERA_KEYS[key], pressed)
        return True
    if key in OBJECT_KEYS:
        if pressed:
            rt.move_object(*OBJECT_KEYS[key])
        return True
    if key in DIMENSION_KEYS:
        rt.set_dimension_lock(key, pressed)
        return True
    if key == "escape":
        if pressed:
            rt.stop_object_dragging()
        return True
    return False


def clear_camera_keys(rt) -> None:
    """Focus-loss handler: release every held camera key
    (reference gui.py:1810-1820)."""
    for k in list(rt.camera_controller.keys_pressed):
        rt.set_camera_key_state(k, False)


class MouseRouter:
    """Display-mouse state machine (reference gui.py:1655-1727).

    Right button rotates the camera; left button starts a drag when any
    dimension lock is held, otherwise selects. Coordinates are normalized
    [0,1] as emitted by the display widget.
    """

    ROTATE_GAIN = 300.0  # normalized delta -> rotate units (gui.py:1692)

    def __init__(self, rt):
        self.rt = rt
        self.last: Optional[tuple] = None
        self.rotating = False
        self.dragging = False

    def press(self, x: float, y: float, button: str) -> None:
        self.last = (x, y)
        if button == "right":
            self.rotating = True
            self.rt.start_camera_rotation(x, y)
            return
        dragger = self.rt.object_dragger
        if dragger.lock_x or dragger.lock_y or dragger.lock_z:
            self.dragging = bool(self.rt.start_object_dragging(x, y))
        else:
            self.rt.select_object_by_click(x, y)

    def move(self, x: float, y: float) -> None:
        if self.last is None:
            self.last = (x, y)
            return
        dx = x - self.last[0]
        dy = y - self.last[1]
        if self.rotating:
            self.rt.update_camera_rotation(dx * self.ROTATE_GAIN,
                                           dy * self.ROTATE_GAIN)
            self.last = (x, y)
        elif self.dragging:
            self.rt.update_object_dragging(dx, dy)

    def release(self) -> None:
        if self.rotating:
            self.rotating = False
            self.rt.stop_camera_rotation()
        if self.dragging:
            self.dragging = False
            self.rt.stop_object_dragging()
        self.last = None


def normalize_mouse(pos_x: float, pos_y: float, widget_w: int, widget_h: int,
                    pix_w: int, pix_h: int) -> Optional[tuple]:
    """Widget coords -> normalized [0,1] image coords, accounting for the
    letterboxing around an aspect-preserving scaled pixmap
    (reference ImageDisplay, gui.py:86-104). None when outside the image."""
    ox = (widget_w - pix_w) / 2
    oy = (widget_h - pix_h) / 2
    x = (pos_x - ox) / max(1, pix_w)
    y = (pos_y - oy) / max(1, pix_h)
    if 0 <= x <= 1 and 0 <= y <= 1:
        return x, y
    return None


def to_uint8(image: np.ndarray) -> np.ndarray:
    """Image -> contiguous uint8 RGB for display. Float inputs are [0,1];
    uint8 inputs (the device-quantized display stack) pass through."""
    if image.dtype == np.uint8:
        return np.ascontiguousarray(image)
    return np.ascontiguousarray(
        (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))


def format_status(frame: dict, max_samples: int) -> tuple[str, int]:
    """Frame dict -> (status-bar text, progress percent)
    (reference gui.py:1610-1648)."""
    if frame.get("is_raytracing"):
        samples = frame["samples"]
        text = (f"Samples: {samples}/{max_samples} | "
                f"Batch: {frame['render_time']:.3f}s | Mode: {frame['mode']}")
        # Under adaptive tiles "samples" is max-of-tiles; append the
        # honest per-tile picture (VERDICT r3 weak #8)
        if frame.get("active_tiles") is not None:
            lo, med, hi = frame.get("tile_samples") or (samples,) * 3
            text += (f" | Tiles: {frame['active_tiles']}/"
                     f"{frame.get('n_tiles', '?')} active, "
                     f"spp/tile {lo}–{med}–{hi}")
        return text, int(100 * samples / max(1, max_samples))
    return f"Mode: {frame['mode']}", 0


def object_list_entries(rt) -> tuple[list, int]:
    """(dropdown entries, index of the current selection) for the object tab
    (reference gui.py:461-554). Entries are (label, object_id)."""
    entries = [(f"{s.object_id}: {s.name or 'Sphere'}", s.object_id)
               for s in rt.scene.spheres]
    oid = rt.settings["selected_object"]
    current = next((i for i, (_, e) in enumerate(entries) if e == oid), -1)
    return entries, current


def select_object(rt, object_id: int) -> None:
    """Dropdown selection -> runtime plumbing (settings + dragger)."""
    rt.settings["selected_object"] = object_id
    rt.object_dragger.selected_object_id = object_id


def object_info_text(obj) -> str:
    """One-line object summary for the info label."""
    if obj is None:
        return "none"
    c = obj.center
    return (f"{obj.name}  pos=({c.x:.2f}, {c.y:.2f}, {c.z:.2f}) "
            f"r={obj.radius:.2f}")


def material_slider_values(obj) -> Optional[dict]:
    """Material -> integer slider positions (RGB/metallic/roughness 0-100,
    light power float) — the readback half of the material tab
    (reference gui.py:556-917)."""
    if obj is None:
        return None
    a = obj.material.albedo
    e = obj.material.emission
    vals = {
        "r": int(a.x * 100), "g": int(a.y * 100), "b": int(a.z * 100),
        "metallic": int(obj.material.metallic * 100),
        "roughness": int(obj.material.roughness * 100),
    }
    power = max(e.x, e.y, e.z)
    if power > 0.1:
        vals["light_power"] = power
    return vals


def apply_material_sliders(obj, r: int, g: int, b: int, metallic: int,
                           roughness: int) -> None:
    """Integer slider positions -> material mutation (the write half; the
    caller debounces the expensive scene rebuild, gui.py:130-133)."""
    from ..api import Vector3

    obj.material.albedo = Vector3(r / 100.0, g / 100.0, b / 100.0)
    obj.material.metallic = metallic / 100.0
    obj.material.roughness = roughness / 100.0


def texture_params(scale: float, octaves: int, h: int, s: int,
                   v: int) -> dict:
    """Texture-tab widget values -> set_object_texture params
    (tint only when saturation > 0, reference gui.py:247-325)."""
    params = {"scale": scale, "octaves": octaves}
    if s > 0:
        params["tint_hsv"] = (h, s / 100.0, v / 100.0)
    return params


def toggle_denoiser(settings: dict, method: str, enabled: bool) -> None:
    """Denoiser checkbox -> settings list (sorted, duplicate-free)."""
    sel = set(settings["selected_denoisers"])
    (sel.add if enabled else sel.discard)(method)
    settings["selected_denoisers"] = sorted(sel)


def set_setting(rt, key: str, value) -> None:
    """Settings write; render-affecting keys restart the progressive
    accumulation (reference gui.py:740-746)."""
    rt.settings[key] = value
    if key in ("max_samples", "samples_per_batch", "max_depth",
               "exposure", "enhance_image", "nee", "stratify",
               "adaptive_tiles"):
        # `nee` switches the estimator (stale accumulation would mix two
        # different transports), `stratify` the sampler, and
        # `adaptive_tiles` the per-tile bookkeeping, so they restart
        # like the reference knobs. `noise_target` only moves the stop
        # threshold — no restart.
        rt.restart_rendering()
