"""Fast preview rasterizers: silhouette and wireframe modes.

Re-creates the reference's interaction-time preview renderers
(Renderer.render_silhouette / render_wireframe, interaction.py:357-565):
perspective-projected circles for spheres, a ground grid, selection
crosshair/axes — drawn with built-in numpy primitives (Bresenham-style lines,
midpoint circles) instead of cv2, so the app layer has no OpenCV dependency.
Previews are host-side UI aids by design (SURVEY.md §7 step 9); the card
never sees them. A copy of ``tpu_rt/app/preview.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np

GRID_COLOR = (80, 80, 80)
DEFAULT_COLOR = (200, 200, 200)
SELECTED_COLOR = (255, 255, 0)
CROSSHAIR_COLOR = (0, 255, 255)
AXIS_COLORS = ((255, 0, 0), (0, 255, 0), (0, 0, 255))  # X, Y, Z
REF_PI = 3.14159


def draw_line(buf: np.ndarray, p0, p1, color, thickness: int = 1):
    """Sampled line segment with square brush of given thickness."""
    h, w = buf.shape[:2]
    x0, y0 = p0
    x1, y1 = p1
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    r = max(0, thickness // 2)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xx = np.clip(xs + dx, 0, w - 1)
            yy = np.clip(ys + dy, 0, h - 1)
            buf[yy, xx] = color


def draw_circle(buf: np.ndarray, center, radius: int, color,
                thickness: int = 1):
    """Circle outline by angular sampling (filled ring for thickness > 1)."""
    h, w = buf.shape[:2]
    cx, cy = center
    radius = max(1, int(radius))
    n = max(16, int(2 * math.pi * radius) * 2)
    ang = np.linspace(0.0, 2 * math.pi, n, endpoint=False)
    cos, sin = np.cos(ang), np.sin(ang)
    for t in range(max(1, thickness)):
        rr = max(1, radius - t)
        xs = np.rint(cx + rr * cos).astype(int)
        ys = np.rint(cy + rr * sin).astype(int)
        keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        buf[ys[keep], xs[keep]] = color


class PreviewRenderer:
    """Silhouette + wireframe rasterizer over a camera/scene pair.

    Mirrors the reference Renderer's projection math exactly
    (interaction.py:386-406): camera-basis dot products, perspective divide
    by z * tan_fov, Y-flip, screen clamp.
    """

    def __init__(self, width: int, height: int, camera, scene):
        self.width = width
        self.height = height
        self.camera = camera
        self.scene = scene
        self.silhouette_buffer = np.zeros((height, width, 3), np.uint8)
        self.wireframe_buffer = np.zeros((height, width, 3), np.uint8)

    # -- projection -------------------------------------------------------
    def _basis(self):
        cam = self.camera
        forward = (cam.target - cam.position).normalize()
        world_up_cross = forward.cross(type(cam.position)(0, 1, 0))
        right = world_up_cross.normalize()
        if right.length() == 0:
            right = type(cam.position)(1, 0, 0)
        up = right.cross(forward).normalize()
        return forward, right, up

    def _projector(self, min_z: float) -> Callable:
        cam = self.camera
        width, height = self.width, self.height
        fov = cam.fov * REF_PI / 180.0
        aspect = width / height
        tan_fov = math.tan(fov / 2.0)
        forward, right, up = self._basis()

        def project(point) -> Optional[Tuple[int, int, float]]:
            rel = point - cam.position
            z = rel.dot(forward)
            if z <= min_z:
                return None
            x = rel.dot(right)
            y = rel.dot(up)
            sx = (x / (z * tan_fov * aspect) + 0.5) * width
            sy = (0.5 - y / (z * tan_fov)) * height
            sx = max(0, min(width - 1, sx))
            sy = max(0, min(height - 1, sy))
            return int(sx), int(sy), z

        return project, tan_fov

    def _sphere_screen_radius(self, sphere, z: float, tan_fov: float) -> int:
        return max(2, int((sphere.radius / (z * tan_fov)) * self.height / 2.0))

    # -- modes -------------------------------------------------------------
    def render_silhouette(self, selected_object_id: int = -1) -> np.ndarray:
        """Circles per sphere; yellow + crosshair for the selection
        (interaction.py:370-448). Returns float [0,1] (h,w,3)."""
        buf = self.silhouette_buffer
        buf.fill(0)
        project, tan_fov = self._projector(min_z=0.001)
        for sphere in self.scene.spheres:
            if sphere.object_id == 0:  # ground skipped
                continue
            hit = project(sphere.center)
            if hit is None:
                continue
            sx, sy, z = hit
            radius = self._sphere_screen_radius(sphere, z, tan_fov)
            selected = sphere.object_id == selected_object_id
            draw_circle(buf, (sx, sy), radius,
                        SELECTED_COLOR if selected else DEFAULT_COLOR,
                        3 if selected else 1)
            if selected:
                draw_line(buf, (sx - 10, sy), (sx + 10, sy), CROSSHAIR_COLOR, 2)
                draw_line(buf, (sx, sy - 10), (sx, sy + 10), CROSSHAIR_COLOR, 2)
        return buf.astype(np.float32) / 255.0

    def render_wireframe(self, selected_object_id: int = -1) -> np.ndarray:
        """Ground grid + sphere circles + RGB axes on the selection
        (interaction.py:450-565). Returns float [0,1] (h,w,3)."""
        buf = self.wireframe_buffer
        buf.fill(0)
        project, tan_fov = self._projector(min_z=0.1)
        self._draw_grid(buf, project)
        for sphere in self.scene.spheres:
            if sphere.object_id == 0:
                continue
            hit = project(sphere.center)
            if hit is None:
                continue
            sx, sy, z = hit
            radius = self._sphere_screen_radius(sphere, z, tan_fov)
            selected = sphere.object_id == selected_object_id
            draw_circle(buf, (sx, sy), radius,
                        SELECTED_COLOR if selected else DEFAULT_COLOR,
                        2 if selected else 1)
            if selected:
                self._draw_axes(buf, sphere, (sx, sy), project)
        return buf.astype(np.float32) / 255.0

    def _draw_grid(self, buf, project, grid_size: int = 10, step: float = 1.0):
        """21x21 unit grid on y=0 (interaction.py:517-551)."""
        vec = type(self.camera.position)
        for i in range(-grid_size, grid_size + 1):
            a = i * step
            for j in range(-grid_size, grid_size):
                for p0, p1 in (
                    (vec(a, 0, j * step), vec(a, 0, (j + 1) * step)),
                    (vec(j * step, 0, a), vec((j + 1) * step, 0, a)),
                ):
                    s0, s1 = project(p0), project(p1)
                    if s0 and s1:
                        draw_line(buf, s0[:2], s1[:2], GRID_COLOR, 1)

    def _draw_axes(self, buf, sphere, center_screen, project):
        """RGB axis gizmo: +X red, +Y green, -Z blue
        (interaction.py:553-565)."""
        vec = type(sphere.center)
        offsets = (vec(0.5, 0, 0), vec(0, 0.5, 0), vec(0, 0, -0.5))
        for off, color in zip(offsets, AXIS_COLORS):
            end = project(sphere.center + off)
            if end:
                draw_line(buf, center_screen, end[:2], color, 2)
