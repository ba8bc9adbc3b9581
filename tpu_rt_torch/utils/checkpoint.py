"""Checkpoint / resume for interactive sessions.

Counterpart of ``tpu_rt/utils/checkpoint.py``, with the same ``.npz``
keys and layout, so a session saved by either package loads in the
other: scene + camera + settings + accumulation buffer (+ the live rows
of a triangle mesh) in one file, so a progressive render resumes where
it stopped. Tensors are pulled to the host to be saved; a loaded mesh is
rebuilt as a padded ``TriangleMesh`` on the requested device.
"""

from __future__ import annotations

import json
import warnings
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from ..api import Camera, Scene

FORMAT_VERSION = 1


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _scene_to_arrays(scene: Scene) -> dict:
    n = len(scene.spheres)
    out = {
        "center": np.zeros((n, 3), np.float32),
        "radius": np.zeros((n,), np.float32),
        "albedo": np.zeros((n, 3), np.float32),
        "metallic": np.zeros((n,), np.float32),
        "roughness": np.zeros((n,), np.float32),
        "emission": np.zeros((n, 3), np.float32),
        "ior": np.zeros((n,), np.float32),
        "object_id": np.zeros((n,), np.int32),
    }
    names = []
    for i, s in enumerate(scene.spheres):
        out["center"][i] = s.center.to_array()
        out["radius"][i] = s.radius
        out["albedo"][i] = s.material.albedo.to_array()
        out["metallic"][i] = s.material.metallic
        out["roughness"][i] = s.material.roughness
        out["emission"][i] = s.material.emission.to_array()
        out["ior"][i] = s.material.ior
        out["object_id"][i] = s.object_id
        names.append(s.name)
    out["names"] = np.asarray(names)
    out["background"] = scene.background_color.to_array()
    out["use_bvh"] = np.asarray(scene.use_bvh)
    return out


def _scene_from_arrays(data) -> Scene:
    # the api layer is imported when a session loads: it imports the core
    # modules, which count through utils.profiling
    from ..api import Material, Scene, Sphere, Vector3

    scene = Scene()
    scene.background_color = Vector3.from_array(data["scene_background"])
    scene.use_bvh = bool(data["scene_use_bvh"])
    names = data["scene_names"]
    for i in range(data["scene_radius"].shape[0]):
        s = Sphere()
        s.center = Vector3.from_array(data["scene_center"][i])
        s.radius = float(data["scene_radius"][i])
        m = Material()
        m.albedo = Vector3.from_array(data["scene_albedo"][i])
        m.metallic = float(data["scene_metallic"][i])
        m.roughness = float(data["scene_roughness"][i])
        m.emission = Vector3.from_array(data["scene_emission"][i])
        m.ior = float(data["scene_ior"][i])
        s.material = m
        s.object_id = int(data["scene_object_id"][i])
        s.name = str(names[i])
        scene.add_sphere(s)
    return scene


def _mesh_to_arrays(mesh) -> dict:
    """A TriangleMesh's live rows (padding stripped), on the host."""
    n = int(_host(mesh.valid).sum())
    out = {}
    for name in mesh._fields:
        if name == "valid":
            continue
        out[name] = _host(getattr(mesh, name))[:n]
    out["count"] = np.asarray(n, np.int64)
    return out


def _mesh_from_arrays(data, device):
    from ..ops.triangle import TriangleMesh, _to_mesh, tri_bucket

    n = int(data["mesh_count"])
    cap = tri_bucket(n)
    fields = {}
    for name in TriangleMesh._fields:
        if name == "valid":
            continue
        rows = np.asarray(data[f"mesh_{name}"])
        shape = (cap,) + rows.shape[1:]
        fill = -1 if name == "object_id" else (1.5 if name == "ior" else 0)
        out = np.full(shape, fill, rows.dtype)
        out[:n] = rows
        fields[name] = out
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    fields["valid"] = valid
    return _to_mesh(fields, device)


def save_checkpoint(
    path: str,
    scene: Scene,
    camera: Camera,
    settings: Optional[dict] = None,
    accumulated_image=None,
    total_samples: int = 0,
    mesh=None,
) -> None:
    """Snapshot a full interactive session to one .npz file.

    ``accumulated_image``: (h, w, 3) numpy array or tensor; ``mesh``: an
    optional TriangleMesh rendered beside the spheres, saved with the same
    fidelity as the spheres."""
    payload = {f"scene_{k}": v for k, v in _scene_to_arrays(scene).items()}
    if mesh is not None:
        payload.update(
            {f"mesh_{k}": v for k, v in _mesh_to_arrays(mesh).items()})
    payload["camera"] = np.asarray(
        [camera.position.x, camera.position.y, camera.position.z,
         camera.target.x, camera.target.y, camera.target.z,
         camera.up.x, camera.up.y, camera.up.z,
         camera.fov, camera.aspect_ratio,
         getattr(camera, "aperture", 0.0) or 0.0,
         getattr(camera, "focus_dist", 0.0) or 0.0], np.float64)
    payload["settings_json"] = np.asarray(
        json.dumps(dict(settings) if settings else {}))
    if accumulated_image is not None:
        payload["accumulated_image"] = _host(accumulated_image).astype(
            np.float32)
    payload["total_samples"] = np.asarray(total_samples, np.int64)
    payload["format_version"] = np.asarray(FORMAT_VERSION)
    np.savez_compressed(path, **payload)


def _load(path: str):
    data = np.load(path, allow_pickle=False)
    if int(data["format_version"]) > FORMAT_VERSION:
        raise ValueError("checkpoint from a newer format version")
    from ..api import Camera, Vector3

    scene = _scene_from_arrays(data)
    c = data["camera"]
    camera = Camera()
    camera.position = Vector3(*c[0:3])
    camera.target = Vector3(*c[3:6])
    camera.up = Vector3(*c[6:9])
    camera.fov = float(c[9])
    camera.aspect_ratio = float(c[10])
    # the lens fields came later; older checkpoints are 11 wide
    camera.aperture = float(c[11]) if len(c) > 11 else 0.0
    camera.focus_dist = float(c[12]) if len(c) > 12 else 0.0
    settings = json.loads(str(data["settings_json"]))
    acc = (np.asarray(data["accumulated_image"])
           if "accumulated_image" in data else None)
    total = int(data["total_samples"])
    return data, (scene, camera, settings, acc, total)


def load_checkpoint(path: str) -> Tuple[Scene, Camera, dict,
                                        Optional[np.ndarray], int]:
    """Restore (scene, camera, settings, accumulated_image, total_samples);
    the accumulator comes back as a numpy array.

    Sessions saved with a mesh: use ``load_checkpoint_with_mesh``; this
    5-tuple API warns rather than silently dropping the geometry."""
    data, result = _load(path)
    if "mesh_count" in data:
        warnings.warn(
            f"{path} contains a triangle mesh that load_checkpoint drops; "
            "use load_checkpoint_with_mesh to restore it",
            stacklevel=2,
        )
    return result


def load_checkpoint_with_mesh(path: str, *, device="cuda"):
    """Restore (scene, camera, settings, accumulated_image, total_samples,
    mesh); ``mesh`` is a TriangleMesh on ``device``, or None for a
    sphere-only session."""
    data, result = _load(path)
    mesh = (_mesh_from_arrays(data, device) if "mesh_count" in data
            else None)
    return result + (mesh,)
