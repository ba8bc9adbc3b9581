"""Triangle meshes in the port against the JAX package, and the megakernel's
triangle sweep (K1-tri).

Meshes, scenes and OBJ loads field for field bit-equal to ``tpu_rt``'s; the
megakernel's plain version with a mesh stream for stream against
``render_pallas(..., mesh=, interpret=True)`` (one JAX compile per depth,
shared through module-scoped fixtures); engine routing with meshes; and
``RayTracer.set_mesh`` end to end on the CPU. The CUDA kernel runs on a GPU
only (tests/test_torch_gpu.py, chip_smoke.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import tpu_rt
from tpu_rt.core import scenes as j_scenes
from tpu_rt.ops import triangle as j_tri
from tpu_rt.ops.pallas_megakernel import render_pallas
from tpu_rt.utils import objio as j_objio

from tpu_rt_torch.api import Material, RayTracer, Scene, Sphere, Vector3
from tpu_rt_torch.app import run as app_run
from tpu_rt_torch.core import scenes
from tpu_rt_torch.ops import megakernel as mk
from tpu_rt_torch.ops import triangle as tri
from tpu_rt_torch.render import display, frame
from tpu_rt_torch.utils import objio
from tpu_rt_torch.utils.convert import camera_from_numpy, mesh_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)
CORNELL_POSE = dict(position=(0, 2, 2.5), target=(0, 2, -3))


def to_np_fields(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def assert_mesh_equal(ours, ref):
    assert ours.capacity == ref.capacity
    for k in tri.TriangleMesh._fields:
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


RNG_VERTS = np.random.default_rng(3).normal(0, 2, (40, 3)).astype(np.float32)
RNG_FACES = np.random.default_rng(4).integers(0, 40, (70, 3))
MESH_CASES = {
    "scalar_materials": lambda m: m.make_mesh(
        RNG_VERTS, RNG_FACES, albedo=(0.2, 0.4, 0.6), metallic=0.3,
        roughness=0.1, emission=(1, 2, 3), ior=1.3, object_id=7),
    "per_face_materials": lambda m: m.make_mesh(
        RNG_VERTS, RNG_FACES,
        albedo=np.random.default_rng(5).uniform(0, 1, (70, 3)),
        metallic=np.linspace(0, 1, 70), object_id=np.arange(70)),
    # a face with repeated vertices has a zero normal: the (0, 0, 1) fill
    "degenerate_capacity": lambda m: m.make_mesh(
        RNG_VERTS, [[0, 1, 2], [3, 3, 4], [5, 6, 5]], capacity=300),
    "quad": lambda m: m.quad((-1, 0, -2), (1, 0, -2), (1, 1, -2),
                             (-1, 1, -2), emission=(4, 4, 4)),
    "box": lambda m: m.box(center=(0.5, 1, -3), size=(1, 2, 0.5),
                           albedo=(0.9, 0.1, 0.1)),
    "merge": lambda m: m.merge_meshes(
        [m.box(size=(2, 2, 2)), m.quad((0, 0, 0), (1, 0, 0), (1, 1, 0),
                                       (0, 1, 0), object_id=3)]),
}


class _OnCpu:
    """The port's triangle module with ``device=CPU`` filled in, so one
    case builds both packages' meshes."""

    make_mesh = staticmethod(lambda *a, **k: tri.make_mesh(*a, device=CPU,
                                                           **k))
    quad = staticmethod(lambda *a, **k: tri.quad(*a, device=CPU, **k))
    box = staticmethod(lambda *a, **k: tri.box(*a, device=CPU, **k))
    merge_meshes = staticmethod(tri.merge_meshes)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_meshes_match_jax_bit_for_bit(case):
    assert_mesh_equal(MESH_CASES[case](_OnCpu), MESH_CASES[case](j_tri))


def test_tri_bucket_and_attribute_matrix_match_jax():
    assert tri.MIN_TRI_BUCKET == j_tri.MIN_TRI_BUCKET
    for n in (0, 1, 128, 129, 10082):
        assert tri.tri_bucket(n) == j_tri.tri_bucket(n)
    ours = MESH_CASES["per_face_materials"](_OnCpu)
    ref = MESH_CASES["per_face_materials"](j_tri)
    np.testing.assert_array_equal(tri.tri_attribute_matrix(ours).numpy(),
                                  np.asarray(j_tri.tri_attribute_matrix(ref)))


@pytest.mark.parametrize("which", ["terrain_12", "terrain_72", "cornell"])
def test_mesh_scenes_match_jax(which):
    if which == "cornell":
        (ts, tm), (js, jm) = (scenes.cornell_box(device=CPU),
                              j_scenes.cornell_box())
    else:
        n = int(which.split("_")[1])
        ts, tm = scenes.terrain_mesh(n=n, seed=1, device=CPU)
        js, jm = j_scenes.terrain_mesh(n=n, seed=1)
    assert_mesh_equal(tm, jm)
    for k, v in to_np_fields(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), v, err_msg=k)


def test_mesh_from_numpy_carries_jax_meshes():
    _, jm = j_scenes.cornell_box()
    assert_mesh_equal(mesh_from_numpy(to_np_fields(jm), CPU), jm)


OBJ = """\
# two objects, a polygon, negative and slashed indices
mtllib scene.mtl
o red_quad
usemtl red
v -1 0 -3
v  1 0 -3
v  1 2 -3
v -1 2 -3
f 1 2 3 4
o lamp
usemtl lamp
v -1 3 -3
v  1 3 -3
v  0 4 -3
v  0.5 3.5 -2
f -4/-4 -3//-3 -2/1/2 -1
g plain
usemtl missing
f 1 3 5
"""

MTL = """\
newmtl red
Kd 0.9 0.1 0.1
Ns 500
Ni 1.3
newmtl lamp
Kd 0.0 0.0 0.0
Ke 5 5 4
Pm 0.7
Pr 0.2
"""


@pytest.mark.parametrize("kw", [dict(), dict(scale=2.5, translate=(1, -2, 0),
                                             capacity=512,
                                             first_object_id=4)],
                         ids=["defaults", "scaled"])
def test_load_obj_matches_jax(tmp_path, kw):
    (tmp_path / "scene.mtl").write_text(MTL)
    path = tmp_path / "scene.obj"
    path.write_text(OBJ)
    ours = objio.load_obj(str(path), device=CPU, **kw)
    assert_mesh_equal(ours, j_objio.load_obj(str(path), **kw))
    assert int(ours.valid.sum()) == 5  # 2 + 2 fanned triangles + 1


def test_save_obj_round_trip(tmp_path):
    _, mesh = scenes.cornell_box(device=CPU)
    path = tmp_path / "cornell.obj"
    objio.save_obj(str(path), mesh)
    back = objio.load_obj(str(path), device=CPU)
    n = int(mesh.valid.sum())
    assert int(back.valid.sum()) == n == 12
    # %.7g keeps these coordinates exactly; materials are the defaults
    for k in ("v0", "e1", "e2", "normal"):
        np.testing.assert_array_equal(getattr(back, k)[:n].numpy(),
                                      getattr(mesh, k)[:n].numpy(), err_msg=k)
    j_path = tmp_path / "cornell_jax.obj"
    j_objio.save_obj(str(j_path), j_scenes.cornell_box()[1])
    assert path.read_text() == j_path.read_text()


def cornell_both(width, height):
    """The Cornell box and its camera in both packages."""
    js, jm = j_scenes.cornell_box()
    jc = tpu_rt.make_camera(aspect=width / height, **CORNELL_POSE)
    ts, tm = scenes.cornell_box(device=CPU)
    return js, jm, jc, ts, tm, camera_from_numpy(to_np_fields(jc), CPU)


MESH_KW = dict(n_active=4, n_tri_active=12)


def test_plain_depth1_bit_identical_to_render_pallas():
    js, jm, jc, ts, tm, tc = cornell_both(96, 64)
    kw = dict(width=96, height=64, spp=1, max_depth=1, jitter=False,
              **MESH_KW)
    ref = np.asarray(render_pallas(js, jc, 3, interpret=True, mesh=jm, **kw))
    ours = mk.render_megakernel_reference(ts, tc, 3, mesh=tm, **kw).numpy()
    assert ours.shape == (64, 96, 3) and (ours > 0).any()
    np.testing.assert_array_equal(ours, ref)


FULL_DEPTH = dict(width=100, height=50, spp=2, max_depth=4, with_stats=True,
                  **MESH_KW)


@pytest.fixture(scope="module")
def full_depth():
    """Both packages' (image, segments) at FULL_DEPTH, by seed: the seed is
    traced, so one JAX interpret-mode compile serves every seed."""
    js, jm, jc, ts, tm, tc = cornell_both(100, 50)
    out = {}

    def render(seed):
        if seed not in out:
            ref, ref_segs = render_pallas(js, jc, seed, interpret=True,
                                          mesh=jm, **FULL_DEPTH)
            ours, segs = mk.render_megakernel_reference(ts, tc, seed, mesh=tm,
                                                        **FULL_DEPTH)
            out[seed] = (np.asarray(ref), int(ref_segs), ours.numpy(),
                         int(segs))
        return out[seed]
    return render


@pytest.mark.parametrize("seed", [7, 2**31 - 2])
def test_plain_matches_render_pallas_full_depth(full_depth, seed):
    """100x50 with jitter, 2 spp, depth 4 (Russian roulette): the slack
    covers branch flips from transcendental ulps between XLA:CPU and
    torch."""
    ref, ref_segs, ours, segs = full_depth(seed)
    d = np.abs(ours - ref)
    assert float((d <= 1e-4).mean()) >= 0.999
    assert abs(segs - ref_segs) <= 1e-3 * ref_segs


def test_wrapper_on_cpu_is_the_plain_version_with_a_mesh():
    _, _, _, ts, tm, tc = cornell_both(64, 32)
    kw = dict(width=64, height=32, spp=2, max_depth=3, with_stats=True,
              **MESH_KW)
    before = mk.render_megakernel.launches
    a, sa = mk.render_megakernel(ts, tc, 11, mesh=tm, **kw)
    b, sb = mk.render_megakernel_reference(ts, tc, 11, mesh=tm, **kw)
    assert mk.render_megakernel.launches == before
    assert torch.equal(a, b) and int(sa) == int(sb)
    # the mesh changes the image: the walls hide the background
    c = mk.render_megakernel(ts, tc, 11, **{k: v for k, v in kw.items()
                                            if k != "n_tri_active"})[0]
    assert not torch.equal(a, c)


def test_megakernel_rejects_more_than_256_triangles():
    ts, tm = scenes.terrain_mesh(n=24, seed=1, device=CPU)
    cam = tpu_rt.make_camera()
    tc = camera_from_numpy(to_np_fields(cam), CPU)
    with pytest.raises(ValueError, match="256"):
        mk.render_megakernel(ts, tc, 0, width=8, height=8, spp=1,
                             max_depth=1, mesh=tm, n_tri_active=257)


def test_select_engine_routes_meshes_as_jax():
    cs, cm = scenes.cornell_box(device=CPU)
    ts, tm = scenes.terrain_mesh(n=24, seed=1, device=CPU)  # 1058 triangles
    assert cm.capacity == 128 and tm.capacity == 2048
    assert frame.select_engine(cs, mesh=cm) == "pallas"
    assert frame.select_engine(ts, mesh=tm) == "cluster"
    assert frame.select_engine(cs, mesh=cm, engine="cluster") == "cluster"
    big = tri.make_mesh(RNG_VERTS, RNG_FACES, capacity=512, device=CPU)
    assert frame.select_engine(cs, mesh=big) == "cluster"
    # the Cornell box renders with NEE through the megakernel
    cam = camera_from_numpy(to_np_fields(tpu_rt.make_camera()), CPU)
    kw = dict(width=8, height=8, spp=1, max_depth=2, nee=True)
    assert torch.equal(frame.render(cs, cam, 0, mesh=cm, **kw),
                       mk.render_megakernel_reference(
                           cs, cam, 0, mesh=cm, n_active=4, n_tri_active=12,
                           **kw))


def test_render_derives_n_tri_active():
    _, _, _, ts, tm, tc = cornell_both(32, 16)
    kw = dict(width=32, height=16, spp=1, max_depth=2)
    a = frame.render(ts, tc, 5, mesh=tm, **kw)
    b = mk.render_megakernel_reference(ts, tc, 5, mesh=tm, **MESH_KW, **kw)
    assert torch.equal(a, b)


def cornell_api_scene() -> Scene:
    """The Cornell box's two spheres as api objects."""
    host, _ = scenes.cornell_box(device=CPU)
    scene = Scene()
    scene.background_color = Vector3(*host.background.tolist())
    for i in range(2):
        s = Sphere()
        s.center = Vector3(*host.center[i].tolist())
        s.radius = float(host.radius[i])
        m = Material()
        m.albedo = Vector3(*host.albedo[i].tolist())
        m.metallic = float(host.metallic[i])
        m.roughness = float(host.roughness[i])
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


def test_raytracer_set_mesh_cornell_end_to_end():
    """RayTracer + set_mesh(Cornell): the megakernel engine with the mesh,
    to an accumulator equal to the same chain through the plain version;
    clearing the mesh renders the spheres alone."""
    rt = RayTracer(seed=4, device=CPU)
    rt.set_scene(cornell_api_scene())
    _, mesh = scenes.cornell_box(device=CPU)
    rt.set_mesh(mesh)
    assert rt._n_tri_active == 12 and rt._tri_clustered is None
    cam = rt.get_camera()
    cam.position, cam.target = (Vector3(*CORNELL_POSE["position"]),
                                Vector3(*CORNELL_POSE["target"]))
    rt.set_camera(cam)
    w, h, spp = 48, 32, 2
    acc, total = None, 0
    for _ in range(2):
        batch = rt.render_device(w, h, spp, 3)
        acc, total = frame.accumulate(acc, total, batch, spp)
    assert rt._last_engine == "pallas"
    stack = display.display_stack(acc, 1.5, as_uint8=True)
    assert stack.shape == (2, h, w, 3) and int(stack.max()) > 0

    scene = rt._scene_arrays
    acc_p, total_p = None, 0
    for f in range(2):
        b = mk.render_megakernel_reference(
            scene, rt.camera.to_params(CPU), (5 * 1000003 + f) & 0x7FFFFFFF,
            width=w, height=h, spp=spp, max_depth=3, mesh=mesh,
            n_active=4, n_tri_active=12)
        acc_p, total_p = frame.accumulate(acc_p, total_p, b, spp)
    assert torch.equal(acc, acc_p) and total == total_p

    rt.set_mesh(None)
    alone = rt.render_device(w, h, spp, 3)
    assert rt._mesh is None and rt._n_tri_active is None
    assert torch.equal(alone, mk.render_megakernel_reference(
        scene, rt.camera.to_params(CPU), (5 * 1000003 + 2) & 0x7FFFFFFF,
        width=w, height=h, spp=spp, max_depth=3, n_active=4))
    rt.set_scene(Scene())
    rt.set_mesh(mesh)
    assert rt.render_device(w, h, spp, 3) is None  # no spheres: no render


def test_headless_app_renders_an_obj(tmp_path):
    _, mesh = scenes.cornell_box(device=CPU)
    obj = tmp_path / "cornell.obj"
    objio.save_obj(str(obj), mesh)
    out = tmp_path / "x.png"
    rc = app_run.main(["--headless", "--device", "cpu", "--width", "32",
                       "--height", "24", "--samples", "2", "--batch", "2",
                       "--depth", "2", "--obj", str(obj), "--obj-scale",
                       "0.5", "--output", str(out)])
    assert rc == 0
    assert out.exists() or (tmp_path / "x.png.npy").exists()


def test_cuda_source_constants_match_python():
    """The kernel cannot run here; its triangle table size and row width
    must be the wrapper's."""
    from tpu_rt_torch.kernels import build

    csrc = os.path.join(os.path.dirname(mk.__file__), os.pardir, "csrc")
    src = open(os.path.join(csrc, "megakernel.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kMaxTris") == mk.MAX_TRIS
    _, mesh = scenes.cornell_box(device=CPU)
    assert const("kTriCols") == mk._pack_tris(mesh, 12).shape[1]
    sig = re.search(r"int tpurt_megakernel_launch\(([^)]*)\)", src)[1]
    assert len(sig.split(",")) == len(
        build.SIGNATURES["tpurt_megakernel_launch"])
