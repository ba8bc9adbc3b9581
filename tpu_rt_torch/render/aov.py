"""First-hit AOVs (arbitrary output variables): normal, depth, albedo.

Counterpart of ``tpu_rt/render/aov.py``: geometry feature buffers for the
guided denoiser (``ops/post.py:joint_bilateral``), from one deterministic
primary-ray pass at pixel centres through the dense closest-hit sweeps
(``ops/intersect.py:intersect_brute``, ``ops/triangle.py:
intersect_mesh_brute``), no bounces. It depends on the camera and scene
only, so an interactive caller computes it once per pose. The sweeps run
on the scene's device.
"""

from __future__ import annotations

import torch

from ..core import camera as cammod
from ..core.types import T_MAX, CameraP, SphereScene
from ..ops.intersect import attribute_matrix, combine_hits, intersect_brute
from ..ops.triangle import intersect_mesh_brute


def render_aovs(scene: SphereScene, cam: CameraP, width: int = 640,
                height: int = 480, mesh=None) -> dict:
    """First-hit feature buffers at pixel centres.

    Returns a dict:
      normal (h, w, 3) -- outward unit normal, zeros on a miss
      depth  (h, w)    -- hit distance t, T_MAX on a miss
      albedo (h, w, 3) -- surface albedo, the background colour on a miss
      object_id (h, w) -- the winner's object id (f32), -1 on a miss
      hit    (h, w)    -- bool coverage mask
    """
    r = height * width
    u, v = cammod.pixel_uv(width, height, None, device=scene.device)
    o, d = cammod.generate_rays(cam, u.reshape(r), v.reshape(r))

    hit = intersect_brute(scene, o, d, attr=attribute_matrix(scene))
    if mesh is not None:
        hit = combine_hits(hit, intersect_mesh_brute(mesh, o, d))

    covered = hit.hit[:, None]
    return {
        "normal": torch.where(covered, hit.normal,
                              torch.zeros_like(hit.normal)).reshape(
                                  height, width, 3),
        "depth": torch.where(hit.hit, hit.t,
                             torch.full_like(hit.t, T_MAX)).reshape(
                                 height, width),
        "albedo": torch.where(covered, hit.albedo,
                              scene.background[None, :]).reshape(
                                  height, width, 3),
        "object_id": hit.object_id.reshape(height, width),
        "hit": hit.hit.reshape(height, width),
    }
