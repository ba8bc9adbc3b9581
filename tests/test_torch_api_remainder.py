"""The rest of the port's drop-in api surface against the JAX package's.

Ray, HitRecord, Sphere.hit, Scene.hit, cast_ray_for_selection,
Camera.get_ray, RayTracer.select_object and DebugInfo are plain Python
floats in both packages: on seeded rays they give the same numbers, float
for float. The signatures the app calls match tpu_rt's: ``to_params()``
with no argument, ``to_arrays(256)`` as a capacity, and a camera without
(or with a None) aperture. ``trace_ray`` runs the lax integrator's
``trace`` with the key ``fold_in(key(seed), frame)``.
"""

import numpy as np
import pytest
import torch

import tpu_rt.api as J

from tpu_rt_torch.api import (
    Camera, DebugInfo, HitRecord, Material, Ray, RayTracer, Scene, Sphere,
    Vector3,
)
from tpu_rt_torch.app.interaction import SceneManager
from tpu_rt_torch.core import rng
from tpu_rt_torch.ops.integrator import trace

CPU = torch.device("cpu")
torch.set_num_threads(1)


def both_scenes():
    """The interactive scene plus a glass sphere around the camera's
    path, built alike in both packages."""
    import tpu_rt.app.interaction as JI

    ours = SceneManager.create_interactive_scene()
    theirs = JI.SceneManager.create_interactive_scene()
    for scene, V, S in ((ours, Vector3, Sphere), (theirs, J.Vector3,
                                                   J.Sphere)):
        s = S()
        s.center = V(0.3, 1.2, 1.0)
        s.radius = 0.7
        s.object_id = 9
        scene.add_sphere(s)
    return ours, theirs


def seeded_rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)) + np.array([0.0, 2.0, 4.0])
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2])  # towards the scene
    return o, d


def rec_tuple(rec):
    return (rec.t, rec.point.x, rec.point.y, rec.point.z, rec.normal.x,
            rec.normal.y, rec.normal.z, rec.front_face, rec.object_id)


def test_vector3_from_array_and_ray():
    v = Vector3.from_array(np.array([1.5, -2.0, 3.25], np.float32))
    assert (v.x, v.y, v.z) == (1.5, -2.0, 3.25)
    r = Ray(Vector3(0, 0, 0), Vector3(0, 0, -5))
    assert abs(r.direction.z + 1.0) < 1e-12
    assert r.at(3.0).z == -3.0
    jr = J.Ray(J.Vector3(1, 2, 3), J.Vector3(0.3, -0.2, 0.9))
    ours = Ray(Vector3(1, 2, 3), Vector3(0.3, -0.2, 0.9))
    for t in (0.0, 0.5, 7.25):
        a, b = ours.at(t), jr.at(t)
        assert (a.x, a.y, a.z) == (b.x, b.y, b.z)
    rec = HitRecord()
    assert rec.t == 0.0 and rec.front_face and rec.object_id == 0
    assert rec.material.albedo.x == Material().albedo.x == 0.8


def test_sphere_hit_equals_jax_on_seeded_rays():
    ours, theirs = both_scenes()
    o, d = seeded_rays(400)
    hits = 0
    for oi, di in zip(o, d):
        r = Ray(Vector3(*oi), Vector3(*di))
        jr = J.Ray(J.Vector3(*oi), J.Vector3(*di))
        for s, js in zip(ours.spheres, theirs.spheres):
            a, b = HitRecord(), J.HitRecord()
            got = s.hit(r, 1e-3, 1e10, a)
            assert got == js.hit(jr, 1e-3, 1e10, b)
            if got:
                hits += 1
                assert rec_tuple(a) == rec_tuple(b)
    assert hits > 100
    # from inside: the normal flips, in both
    s = Sphere()
    s.center = Vector3(0, 0, -3)
    rec = HitRecord()
    assert s.hit(Ray(Vector3(0, 0, -3), Vector3(0, 0, -1)), 1e-3, 1e10, rec)
    assert not rec.front_face and rec.normal.z == 1.0


def test_scene_hit_and_selection_equal_jax_on_seeded_rays():
    ours, theirs = both_scenes()
    o, d = seeded_rays(600, seed=1)
    ids = set()
    for oi, di in zip(o, d):
        r = Ray(Vector3(*oi), Vector3(*di))
        jr = J.Ray(J.Vector3(*oi), J.Vector3(*di))
        a, b = HitRecord(), J.HitRecord()
        got = ours.hit(r, 1e-3, 1e10, a)
        assert got == theirs.hit(jr, 1e-3, 1e10, b)
        if got:
            assert rec_tuple(a) == rec_tuple(b)
        sel = ours.cast_ray_for_selection(r, 1e-3, 1000.0)
        assert sel == theirs.cast_ray_for_selection(jr, 1e-3, 1000.0)
        ids.add(sel)
    assert -1 in ids and len(ids) >= 5


def test_camera_get_ray_equals_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        p, t = rng.uniform(-4, 4, 3), rng.uniform(-4, 4, 3)
        fov, aspect = float(rng.uniform(20, 90)), float(rng.uniform(0.5, 2))
        cam, jcam = Camera(), J.Camera()
        for c, V in ((cam, Vector3), (jcam, J.Vector3)):
            c.position, c.target = V(*p), V(*t)
            c.fov, c.aspect_ratio = fov, aspect
        for u, v in rng.uniform(0, 1, (10, 2)):
            a, b = cam.get_ray(u, v), jcam.get_ray(u, v)
            assert (a.origin.x, a.direction.x, a.direction.y,
                    a.direction.z) == (b.origin.x, b.direction.x,
                                       b.direction.y, b.direction.z)
    cam = Camera()
    cam.position, cam.target = Vector3(0, 0, 0), Vector3(0, 0, -1)
    assert abs(cam.get_ray(0.5, 0.5).direction.z + 1) < 1e-9
    cam.rotate(10, 10)  # no-op like v1
    assert cam.position.x == 0 and cam.target.z == -1
    cam.move(Vector3(1, 0, 0))
    assert cam.position.x == 1


def test_select_object_equals_jax():
    ours, theirs = both_scenes()
    rt, jrt = RayTracer(device=CPU), J.RayTracer()
    rt.set_scene(ours)
    jrt.set_scene(theirs)
    for r in (rt, jrt):
        r.camera.aspect_ratio = 4 / 3
    picked = set()
    for x in np.linspace(0.02, 0.98, 15):
        for y in np.linspace(0.02, 0.98, 11):
            got = rt.select_object(float(x), float(y), 640, 480)
            assert got == jrt.select_object(float(x), float(y), 640, 480)
            picked.add(got)
    assert {-1, 0, 1, 3, 9} <= picked


def test_debug_info_and_counters_follow_jax():
    d, jd = DebugInfo(), J.DebugInfo()
    assert (d.enable_debug, d.build_count, d.render_count) == (
        jd.enable_debug, jd.build_count, jd.render_count)
    for x in (d, jd):
        x.build_count = 3
        x.render_count = 2
    assert d.get_stats() == jd.get_stats() == "Builds: 3, Renders: 2"
    d.reset()
    jd.reset()
    assert d.get_stats() == jd.get_stats() == "Builds: 0, Renders: 0"
    ours, theirs = both_scenes()
    rt = RayTracer(device=CPU)
    rt.set_debug_mode(True)
    assert rt.get_debug_info().enable_debug
    rt.set_scene(ours)
    rt.set_scene(ours)
    rt.render(16, 12, 1, 1)
    info = rt.get_debug_info()
    assert (info.build_count, info.render_count) == (2, 1)
    assert rt._last_use_bvh is False  # only the lax engine traverses one
    jrt = J.RayTracer()
    jrt.set_scene(theirs)
    jrt.set_scene(theirs)
    assert jrt.get_debug_info().build_count == 2
    # scene bookkeeping
    s = Scene()
    assert s._dirty and s._build_count == 0
    s._dirty = False
    s.build_bvh()
    assert s._dirty and s._build_count == 1
    s._dirty = False
    s.add_sphere(Sphere())
    assert s._dirty
    s._dirty = False
    s.remove_sphere(0)
    assert s._dirty and not s.spheres


def test_to_params_without_device_lands_on_the_tracers():
    """The app calls cam.to_params() with no argument
    (tpu_rt/app/interaction.py:697)."""
    rt = RayTracer(device=CPU)
    p = rt.camera.to_params()
    assert p.position.device == CPU
    assert p.position.tolist() == [0.0, 2.0, 5.0]
    assert rt.get_camera().to_params().fov.device == CPU
    cam = Camera()
    rt.set_camera(cam)
    assert cam.to_params().fov.device == CPU
    assert cam.to_params(CPU).fov.device == CPU  # positional, as before
    # a camera no tracer holds goes to the card, never silently to the CPU
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Camera().to_params()


def test_to_arrays_positional_capacity_as_in_jax():
    """to_arrays(256) is a capacity, as in tpu_rt; the device comes from
    the tracer holding the snapshot."""
    ours, theirs = both_scenes()
    rt = RayTracer(device=CPU)
    rt.set_scene(ours)
    arrays = rt._scene_snapshot.to_arrays(256)
    assert arrays.capacity == 256 == theirs.to_arrays(256).capacity
    assert arrays.device == CPU
    assert int(arrays.valid.sum()) == len(ours.spheres)
    np.testing.assert_array_equal(arrays.center.numpy(),
                                  np.asarray(theirs.to_arrays(256).center))
    assert ours.to_arrays(device=CPU).capacity == 16
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ours.to_arrays()


@pytest.mark.parametrize("lens", ["deleted", "none"])
def test_camera_without_aperture_renders(lens):
    """A camera set_camera took without an aperture, or with None, renders
    as a pinhole, as tpu_rt reads getattr(cam, "aperture", 0.0) or 0.0."""
    rt, ref = RayTracer(seed=4, device=CPU), RayTracer(seed=4, device=CPU)
    scene, theirs = both_scenes()
    for r in (rt, ref):
        r.set_scene(scene)
    cam = rt.get_camera()
    if lens == "deleted":
        del cam.aperture
        del cam.focus_dist
    else:
        cam.aperture = cam.focus_dist = None
    rt.set_camera(cam)
    img = rt.render_device(32, 24, 1, 2)
    assert torch.equal(img, ref.render_device(32, 24, 1, 2))
    p = cam.to_params()
    assert float(p.aperture) == 0.0 and float(p.focus_dist) == 0.0
    copy = rt.get_camera()
    assert copy.aperture == 0.0 and copy.focus_dist == 0.0
    if lens == "deleted":  # the JAX package's reading of the same camera
        jcam = J.Camera()
        del jcam.aperture
        assert float(jcam.to_params().aperture) == 0.0


def test_trace_ray_raises_naming_the_lax_integrator():
    rt = RayTracer(device=CPU)
    rt.set_scene(SceneManager.create_interactive_scene())
    ray = Ray(Vector3(0, 2, 5), Vector3(0, 1, -6))
    got = [rt.trace_ray(ray, 4, 4) for _ in range(2)]
    assert rt._frame == 2
    o = torch.tensor([[0.0, 2.0, 5.0]])
    d = torch.tensor([[0.0, 1.0, -6.0]])
    for frame, v in enumerate(got):
        ref = trace(rt._scene_arrays, o, d,
                    rng.fold_in(rng.key(0, device=CPU), frame), max_depth=4)
        assert [v.x, v.y, v.z] == ref[0].tolist()
