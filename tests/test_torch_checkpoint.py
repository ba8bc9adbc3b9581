"""Session checkpoints, settings and frame counters of the port.

A checkpoint saved by either package loads in the other with equal
contents: scene, camera (lens included), settings, accumulator, sample
count and a triangle mesh, rebuilt on the requested device. The port's
RenderSettings, FrameStats, sync and torch_trace behave as the JAX
package's counterparts do.
"""

import json
import os

import numpy as np
import pytest
import torch

import tpu_rt.app.interaction as JI
import tpu_rt.utils as JU
from tpu_rt.api import Camera as JCamera
from tpu_rt.api import Vector3 as JVector3
from tpu_rt.ops import triangle as j_triangle

from tpu_rt_torch.api import Camera, RayTracer, Scene, Vector3
from tpu_rt_torch.app.interaction import SceneManager
from tpu_rt_torch.core.scenes import terrain_mesh
from tpu_rt_torch.ops import triangle
from tpu_rt_torch.utils import (
    FrameStats,
    RenderSettings,
    load_checkpoint,
    load_checkpoint_with_mesh,
    save_checkpoint,
    sync,
    torch_trace,
)

CPU = torch.device("cpu")
torch.set_num_threads(1)
SETTINGS = {"max_samples": 64, "selected_denoisers": ["median"],
            "noise_target": 0.05, "adaptive_tiles": True}
BOX = dict(center=(0, 1, -3), size=(1.5, 1.0, 0.5), albedo=(0.9, 0.2, 0.1),
           emission=(0.0, 0.5, 0.0))


def accumulator():
    return np.random.default_rng(0).uniform(0, 1, (24, 32, 3)).astype(
        np.float32)


def lens_camera(C, V):
    cam = C()
    cam.position = V(1, 2, 3)
    cam.target = V(0.5, 0.25, -2)
    cam.fov = 60.0
    cam.aspect_ratio = 1.5
    cam.aperture = 0.125
    cam.focus_dist = 4.5
    return cam


def scene_rows(scene):
    return [(s.name, s.object_id, s.radius, s.center.x, s.center.y,
             s.center.z, s.material.albedo.x, s.material.albedo.y,
             s.material.albedo.z, s.material.metallic, s.material.roughness,
             s.material.emission.x, s.material.emission.z, s.material.ior)
            for s in scene.spheres] + [
        (scene.background_color.x, scene.background_color.z, scene.use_bvh)]


def camera_row(c):
    return (c.position.x, c.position.y, c.position.z, c.target.x,
            c.target.y, c.target.z, c.up.y, c.fov, c.aspect_ratio,
            c.aperture, c.focus_dist)


def mesh_fields(mesh):
    return {f: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for f, v in mesh._asdict().items()}


@pytest.mark.parametrize("with_mesh", [False, True])
def test_jax_checkpoint_loads_in_port(tmp_path, with_mesh):
    j_scene = JI.SceneManager.create_interactive_scene()
    j_scene.spheres[2].material.ior = 1.33
    j_mesh = j_triangle.box(**BOX) if with_mesh else None
    acc = accumulator()
    path = str(tmp_path / "jax.npz")
    JU.save_checkpoint(path, j_scene, lens_camera(JCamera, JVector3),
                       SETTINGS, acc, total_samples=24, mesh=j_mesh)
    scene, cam, settings, acc2, total, mesh = load_checkpoint_with_mesh(
        path, device=CPU)
    assert isinstance(scene, Scene) and isinstance(cam, Camera)
    # the file holds f32 spheres: the port reads what the JAX package does
    j_loaded = JU.load_checkpoint_with_mesh(path)[0]
    assert scene_rows(scene) == scene_rows(j_loaded)
    assert scene.spheres[2].material.ior == np.float32(1.33)
    assert camera_row(cam) == camera_row(lens_camera(JCamera, JVector3))
    assert settings == SETTINGS
    np.testing.assert_array_equal(acc2, acc)
    assert total == 24
    if not with_mesh:
        assert mesh is None
        return
    assert isinstance(mesh, triangle.TriangleMesh) and mesh.device == CPU
    ours, theirs = mesh_fields(mesh), mesh_fields(j_mesh)
    assert ours.keys() == theirs.keys()
    for f in ours:
        np.testing.assert_array_equal(ours[f], theirs[f], err_msg=f)
        assert ours[f].dtype == theirs[f].dtype, f


@pytest.mark.parametrize("with_mesh", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, with_mesh):
    scene = SceneManager.create_interactive_scene()
    scene.spheres[4].name = "Renamed"
    mesh = triangle.box(**BOX, device=CPU) if with_mesh else None
    acc = torch.from_numpy(accumulator())  # a tensor is pulled to save
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, scene, lens_camera(Camera, Vector3), SETTINGS,
                    acc, total_samples=16, mesh=mesh)
    j_scene, j_cam, settings, j_acc, total, j_mesh = (
        JU.load_checkpoint_with_mesh(path))
    assert scene_rows(j_scene) == scene_rows(
        load_checkpoint_with_mesh(path, device=CPU)[0])
    assert j_scene.spheres[4].name == "Renamed"
    assert camera_row(j_cam) == camera_row(lens_camera(Camera, Vector3))
    assert settings == SETTINGS
    np.testing.assert_array_equal(j_acc, acc.numpy())
    assert total == 16
    if not with_mesh:
        assert j_mesh is None
        return
    ours, theirs = mesh_fields(mesh), mesh_fields(j_mesh)
    for f in ours:
        np.testing.assert_array_equal(ours[f], theirs[f], err_msg=f)


def test_same_session_same_file_contents(tmp_path):
    """Both packages write the same keys and arrays for the same session."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_checkpoint(a, SceneManager.create_interactive_scene(),
                    lens_camera(Camera, Vector3), SETTINGS, accumulator(), 8,
                    mesh=triangle.box(**BOX, device=CPU))
    JU.save_checkpoint(b, JI.SceneManager.create_interactive_scene(),
                       lens_camera(JCamera, JVector3), SETTINGS,
                       accumulator(), 8, mesh=j_triangle.box(**BOX))
    da, db = np.load(a), np.load(b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        if k == "settings_json":
            assert json.loads(str(da[k])) == json.loads(str(db[k]))
        else:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
            assert da[k].dtype == db[k].dtype, k


def test_checkpoint_roundtrip_and_mesh_warning(tmp_path):
    scene = SceneManager.create_interactive_scene()
    cam = Camera()
    cam.position = Vector3(1, 2, 3)
    cam.fov = 60.0
    acc = accumulator()
    path = str(tmp_path / "session.npz")
    save_checkpoint(path, scene, cam, SETTINGS, acc, total_samples=24)
    s2, c2, set2, acc2, total = load_checkpoint(path)
    assert len(s2.spheres) == 9 and s2.spheres[1].name == "Red Metallic"
    assert s2.spheres[6].material.emission.x == 10
    assert (c2.position.x, c2.position.y, c2.position.z) == (1, 2, 3)
    assert c2.fov == 60.0 and c2.aperture == 0.0
    assert set2["max_samples"] == 64 and total == 24
    np.testing.assert_array_equal(acc2, acc)

    _, mesh = terrain_mesh(n=8, device=CPU)
    p2 = str(tmp_path / "mesh.npz")
    save_checkpoint(p2, Scene(), Camera(), mesh=mesh)
    with pytest.warns(UserWarning, match="load_checkpoint_with_mesh"):
        assert len(load_checkpoint(p2)) == 5
    mesh2 = load_checkpoint_with_mesh(p2, device=CPU)[5]
    n = int(mesh.valid.sum())
    assert int(mesh2.valid.sum()) == n and mesh2.capacity == mesh.capacity
    for f in mesh._fields:
        assert torch.equal(getattr(mesh, f)[:n], getattr(mesh2, f)[:n]), f


def test_restored_scene_renders_identically(tmp_path):
    scene = SceneManager.create_interactive_scene()
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, scene, Camera())
    scene2 = load_checkpoint(path)[0]
    rt1, rt2 = RayTracer(seed=3, device=CPU), RayTracer(seed=3, device=CPU)
    rt1.set_scene(scene)
    rt2.set_scene(scene2)
    np.testing.assert_array_equal(rt1.render(16, 12, 2, 2),
                                  rt2.render(16, 12, 2, 2))


def test_settings_match_jax_package():
    s, j = RenderSettings(), JU.RenderSettings()
    assert s.as_dict() == j.as_dict()
    for key, value in (("max_samples", 5000), ("max_depth", 0),
                       ("exposure", 9.0), ("noise_target", -1.0)):
        s[key] = value
        j[key] = value
        assert s[key] == j[key]
    s.update({"exposure": 2.0}, move_speed=0.5)
    assert s["exposure"] == 2.0 and s.move_speed == 0.5
    assert "exposure" in s and "nope" not in s
    assert set(s.keys()) == set(s.as_dict().keys())


def test_frame_stats_and_timer():
    st = FrameStats(window=3)
    for _ in range(5):
        st.record(0.1, 1_000_000)
    assert len(st.times) == 3
    assert abs(st.frame_ms - 100.0) < 1e-6
    assert abs(st.mrays_per_s - 10.0) < 1e-6
    assert st.summary() == JU.FrameStats(times=[0.1] * 3,
                                         rays=[1_000_000] * 3).summary()
    sync()  # no CUDA work queued: a no-op
    sync([torch.zeros(2), (torch.ones(1),)])


def test_torch_trace_writes_chrome_trace(tmp_path):
    with torch_trace(str(tmp_path / "trace")):
        torch.ones((32, 32)).matmul(torch.ones((32, 32)))
    path = tmp_path / "trace" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert os.path.getsize(path) > 0
