"""A RayTracer's kernel inputs, built once per scene and per camera pose
(``api/compat.py``: ``RayTracer._camera_inputs``, ``_build_inputs``; the
wrappers' ``tables=`` and ``packed_camera=``), on the CPU.

Every batch of a RayTracer equals, bit for bit, a fresh
``render/frame.py:render`` of a freshly built camera and scene at the
batch's seed, across camera moves made in place, fov and aspect changes,
an edited scene, a switch of NEE and a mesh; ``input_builds`` counts one
camera build per distinct pose and one table build per scene, NEE or mesh
change, and nothing on a batch that repeats its pose. Wrappers handed
inputs that do not fit the call refuse them. The card runs the same
checks on the kernels (``tests/test_torch_gpu.py``).
"""

import pytest
import torch

from tpu_rt_torch.api import Camera, Material, RayTracer, Scene, Sphere
from tpu_rt_torch.api import Vector3
from tpu_rt_torch.api.compat import batch_seed
from tpu_rt_torch.app.interaction import SceneManager
from tpu_rt_torch.core.scenes import cornell_box, random_spheres
from tpu_rt_torch.core.types import demo_scene, make_camera
from tpu_rt_torch.ops import cluster
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.render import frame
from tpu_rt_torch.utils import profiling

CPU = torch.device("cpu")
torch.set_num_threads(1)
SHAPE = (32, 32, 1, 2)  # width, height, spp, depth
WIDE = (48, 32, 1, 2)   # another aspect


def _field(n=100):
    """An api Scene of ``n`` random spheres: past 64, the cluster engine."""
    arrays = random_spheres(n, seed=3, spread=4.0, device=CPU)
    scene = Scene()
    for i in range(n):
        s = Sphere()
        s.center = Vector3(*map(float, arrays.center[i]))
        s.radius = float(arrays.radius[i])
        m = Material()
        m.albedo = Vector3(*map(float, arrays.albedo[i]))
        m.metallic = float(arrays.metallic[i])
        m.roughness = float(arrays.roughness[i])
        m.emission = Vector3(*map(float, arrays.emission[i]))
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


def _scene(engine):
    return (SceneManager.create_interactive_scene() if engine == "pallas"
            else _field())


def _fresh(rt, scene, mesh, nee, batch, shape):
    """Batch ``batch`` as a fresh ``frame.render`` would draw it: a new
    Camera with the tracer's camera values, the scene snapshotted anew,
    every kernel input built inside the call."""
    width, height, spp, depth = shape
    c = Camera()
    for name in ("position", "target", "up"):
        setattr(c, name, getattr(rt.camera, name).copy())
    c.fov = rt.camera.fov
    c.aspect_ratio = width / height
    arrays = scene.to_arrays(device=CPU)
    n_tri = None if mesh is None else frame.quantize_count(
        int(mesh.valid.sum()), mesh.capacity)
    return frame.render(
        arrays, c.to_params(CPU), batch_seed(rt._seed_base, batch),
        width=width, height=height, spp=spp, max_depth=depth,
        engine=rt._last_engine, mesh=mesh, n_tri_active=n_tri, nee=nee,
        n_active=frame.quantize_count(len(scene.spheres), arrays.capacity),
        enable_dof=False)


def _session(engine, nee):
    """Drive a RayTracer through the moves and changes a GUI session makes;
    yields (step, input_builds the step counted, batch, the fresh render's
    arguments) for each batch."""
    scene = _scene(engine)
    mesh = None
    rt = RayTracer(seed=5, nee=nee, device=CPU)
    builds = profiling.counts().get("input_builds", 0)

    def step(name, shape=SHAPE):
        nonlocal builds
        batch = rt._frame
        img = rt.render_device(*shape)
        now = profiling.counts().get("input_builds", 0)
        delta, builds = now - builds, now
        return name, delta, img, (rt, scene, mesh, rt._nee, batch, shape)

    rt.set_scene(scene)
    yield step("first")
    yield step("repeat")
    rt.move_camera(Vector3(0.3, 0.0, 0.0))
    yield step("move_camera")
    rt.camera.position = Vector3(0.1, 2.5, 4.0)
    yield step("position")
    rt.set_camera(rt.get_camera())  # another object, the same values
    yield step("same_values")
    rt.camera.fov = 60.0
    yield step("fov")
    yield step("aspect", WIDE)
    scene.spheres[1].material.albedo = Vector3(0.2, 0.7, 0.4)
    scene.spheres[1].material.metallic = 0.0
    rt.set_scene(scene)
    yield step("set_scene", WIDE)
    rt.set_nee(not nee)
    yield step("set_nee", WIDE)
    mesh = cornell_box(device=CPU)[1]
    rt.set_mesh(mesh)
    yield step("set_mesh", WIDE)
    yield step("repeat_mesh", WIDE)


# input_builds a step counts: a camera build on a new pose, a table build on
# a new scene, NEE flag or mesh (set_scene's first one included)
BUILDS = {"first": 2, "repeat": 0, "move_camera": 1, "position": 1,
          "same_values": 0, "fov": 1, "aspect": 1, "set_scene": 1,
          "set_nee": 1, "set_mesh": 1, "repeat_mesh": 0}


@pytest.mark.parametrize("engine, nee", [("pallas", False), ("pallas", True),
                                         ("cluster", False),
                                         ("cluster", True)])
def test_each_batch_equals_a_fresh_render(engine, nee):
    for name, _, img, args in _session(engine, nee):
        assert args[0]._last_engine == engine, name
        assert torch.equal(img, _fresh(*args)), name


@pytest.mark.parametrize("engine", ["pallas", "cluster"])
def test_input_builds_count_poses_and_scene_changes(engine):
    counted = {name: delta for name, delta, _, _ in _session(engine, False)}
    assert counted == BUILDS


def test_lax_engine_builds_the_pose_once_and_renders_as_before():
    rt = RayTracer(seed=2, mode="v1", device=CPU)
    scene = _scene("pallas")
    rt.set_scene(scene)
    before = profiling.counts().get("input_builds", 0)
    for batch in range(2):
        img = rt.render_device(*SHAPE)
        assert rt._last_engine == "lax"
        c = Camera()
        c.aspect_ratio = SHAPE[0] / SHAPE[1]
        for name in ("position", "target", "up", "fov"):
            setattr(c, name, getattr(rt.camera, name))
        ref = frame.render(scene.to_arrays(device=CPU), c.to_params(CPU),
                           batch_seed(rt._seed_base, batch), width=32,
                           height=32, spp=1, max_depth=2, mode="v1",
                           n_active=rt._n_active, enable_dof=False,
                           use_bvh=scene.use_bvh)
        assert torch.equal(img, ref)
    # the pose once; the lax engine has no tables
    assert profiling.counts()["input_builds"] - before == 1


def _demo_call(**kw):
    scene = demo_scene(device=CPU)
    cam = make_camera(aspect=1.0, device=CPU)
    return scene, cam, dict(width=32, height=32, spp=1, max_depth=2,
                            n_active=12, **kw)


def test_megakernel_inputs_passed_equal_inputs_built_per_call():
    scene, cam, kw = _demo_call(nee=True)
    tables = mk.scene_tables(scene, 12, nee=True)
    packed = mk.pack_camera(cam, CPU)
    assert torch.equal(
        mk.render_megakernel(scene, cam, 9, tables=tables,
                             packed_camera=packed, **kw),
        mk.render_megakernel(scene, cam, 9, **kw))


@pytest.mark.parametrize("case", ["nee_without_light_count",
                                  "sphere_count", "mesh", "type",
                                  "camera_shape"])
def test_megakernel_refuses_inputs_that_do_not_fit(case):
    scene, cam, kw = _demo_call(nee=True)
    tables = mk.scene_tables(scene, 12, nee=True)
    packed = mk.pack_camera(cam, CPU)
    err = ValueError
    if case == "nee_without_light_count":
        tables = mk.scene_tables(scene, 12)
    elif case == "sphere_count":
        tables = mk.scene_tables(scene, 16, nee=True)
    elif case == "mesh":
        kw["mesh"] = cornell_box(device=CPU)[1]
    elif case == "type":
        tables, err = tuple(tables), TypeError
    else:
        packed = packed[:15]
    with pytest.raises(err):
        mk.render_megakernel(scene, cam, 9, tables=tables,
                             packed_camera=packed, **kw)


@pytest.mark.parametrize("case", ["nee_without_lights", "mesh", "type"])
def test_cluster_refuses_tables_that_do_not_fit(case):
    scene = random_spheres(100, seed=3, spread=4.0, device=CPU)
    cam = make_camera(aspect=1.0, device=CPU)
    ordered = cluster.order_clusters(
        cluster.build_clusters(scene, n_active=112), cam.position)
    tables = cluster.check_tables(ordered)
    kw = dict(width=32, height=32, spp=1, max_depth=2)
    err = ValueError
    if case == "nee_without_lights":
        kw["nee"] = True
    elif case == "mesh":
        kw["mesh"] = cornell_box(device=CPU)[1]
    else:
        tables, err = ordered, TypeError
    with pytest.raises(err):
        cluster.render_cluster(scene, cam, 9, tables=tables, **kw)
