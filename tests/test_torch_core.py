"""tpu_rt_torch core against tpu_rt: scene and camera construction, camera
math, the attribute table and the packed camera, on the same numpy inputs,
within 2 f32 ulps; numpy conversion round trips bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tpu_rt
from tpu_rt.core import camera as jcam
from tpu_rt.ops.intersect import attribute_matrix as j_attribute_matrix
from tpu_rt.ops.pallas_megakernel import _pack_camera as j_pack_camera

import tpu_rt_torch
from tpu_rt_torch.core import camera as tcam
from tpu_rt_torch.core import types as ttypes
from tpu_rt_torch.ops.intersect import attribute_matrix
from tpu_rt_torch.ops.megakernel import _pack_camera
from tpu_rt_torch.utils.convert import camera_from_numpy, scene_from_numpy

CPU = torch.device("cpu")
# six xdist workers share the CPU: one intra-op thread each keeps
# torch's thread pools from oversubscribing it
torch.set_num_threads(1)


def as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_ulps(ours, ref, n=2, vectors=False):
    """|ours - ref| within n f32 ulps of the larger magnitude.

    ``vectors``: the magnitude is each 3-vector's length. XLA:CPU's rsqrt
    and the FMAs it contracts inside ``jnp.cross`` round the camera basis
    differently in the last bit; a component that cancels (f + r*x + u*y)
    then differs by an ulp of the vector, not of the small component."""
    a = as_np(ours).astype(np.float32)
    b = as_np(ref).astype(np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    mag = np.maximum(np.abs(a), np.abs(b))
    if vectors:
        mag = np.broadcast_to(np.linalg.norm(mag, axis=-1, keepdims=True),
                              mag.shape)
    tol = n * np.spacing(mag)
    bad = np.abs(a.astype(np.float64) - b) > tol
    assert not bad.any(), (a[bad][:5], b[bad][:5])


def np_fields(nt):
    return {k: (None if v is None else np.asarray(v))
            for k, v in nt._asdict().items()}


def random_scene_rows(rng, n):
    return dict(
        centers=rng.uniform(-5, 5, (n, 3)),
        radii=rng.uniform(0.1, 2.0, n),
        albedos=rng.uniform(0, 1, (n, 3)),
        metallics=rng.uniform(0, 1, n),
        roughnesses=rng.uniform(0, 1, n),
        emissions=rng.uniform(0, 4, (n, 3)),
        iors=rng.uniform(1.0, 2.0, n),
        background=rng.uniform(0, 1, 3),
    )


CAMERAS = [
    dict(),
    dict(position=(0.0, 5.0, 0.0), target=(0.0, 0.0, 0.0)),  # +X fallback
    dict(position=(1.5, -0.3, 2.0), target=(-0.7, 0.4, -3.0), fov=70.0,
         aspect=16 / 9),
    dict(position=(3.0, 1.0, 1.0), target=(0.0, 0.5, -1.0), fov=20.0,
         aspect=0.75, focus_dist=2.5),
]


@pytest.mark.parametrize("n", [1, 9, 16, 40])
def test_make_scene_matches(n):
    rows = random_scene_rows(np.random.default_rng(n), n)
    ours = tpu_rt_torch.make_scene(**rows, device=CPU)
    ref = tpu_rt.make_scene(**rows)
    assert ours.capacity == ref.capacity == ttypes.sphere_bucket(n)
    for k in ttypes.SphereScene._fields:
        o, r = as_np(getattr(ours, k)), as_np(getattr(ref, k))
        assert o.dtype == r.dtype, k
        np.testing.assert_array_equal(o, r, err_msg=k)


def test_demo_scene_matches():
    ours = tpu_rt_torch.demo_scene(device=CPU)
    ref = tpu_rt.demo_scene()
    for k in ttypes.SphereScene._fields:
        np.testing.assert_array_equal(as_np(getattr(ours, k)),
                                      as_np(getattr(ref, k)), err_msg=k)
    from tpu_rt.core.types import DEMO_SPHERE_NAMES
    assert ttypes.DEMO_SPHERE_NAMES == DEMO_SPHERE_NAMES
    assert (ttypes.T_MIN, ttypes.T_MAX) == (tpu_rt.core.types.T_MIN,
                                            tpu_rt.core.types.T_MAX)


def test_make_scene_rejects_small_capacity():
    rows = random_scene_rows(np.random.default_rng(0), 20)
    with pytest.raises(ValueError):
        tpu_rt_torch.make_scene(**rows, capacity=16, device=CPU)


@pytest.mark.parametrize("cam_kw", CAMERAS, ids=range(len(CAMERAS)))
def test_camera_math_matches(cam_kw):
    ours = tpu_rt_torch.make_camera(**cam_kw, device=CPU)
    ref = tpu_rt.make_camera(**cam_kw)
    for k in ttypes.CameraP._fields:
        np.testing.assert_array_equal(as_np(getattr(ours, k)),
                                      as_np(getattr(ref, k)), err_msg=k)
    for o, r in zip(tcam.basis(ours), jcam.basis(ref)):
        assert_ulps(o, r, vectors=True)
    assert_ulps(tcam.tan_half_fov(ours), jcam.tan_half_fov(ref))
    packed, j_packed = as_np(_pack_camera(ours)), as_np(j_pack_camera(ref))
    j_packed = j_packed.reshape(16)
    assert_ulps(packed[:12].reshape(4, 3), j_packed[:12].reshape(4, 3),
                vectors=True)
    assert_ulps(packed[12:], j_packed[12:])

    rng = np.random.default_rng(5)
    u = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    v = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    o_t, d_t = tcam.generate_rays(ours, torch.from_numpy(u),
                                  torch.from_numpy(v))
    o_j, d_j = jcam.generate_rays(ref, jnp.asarray(u), jnp.asarray(v))
    assert_ulps(o_t, o_j)
    assert_ulps(d_t, d_j, vectors=True)


@pytest.mark.parametrize("jitter", [False, True])
def test_pixel_uv_matches(jitter):
    xi = None
    if jitter:
        xi = np.random.default_rng(2).uniform(0, 1, (6, 10, 2)).astype(
            np.float32)
    u_t, v_t = tcam.pixel_uv(10, 6, None if xi is None else
                             torch.from_numpy(xi), device=CPU)
    u_j, v_j = jcam.pixel_uv(10, 6, None if xi is None else jnp.asarray(xi))
    assert_ulps(u_t, u_j)
    assert_ulps(v_t, v_j)


@pytest.mark.parametrize("n", [9, 16, 40])
def test_attribute_matrix_matches(n):
    rows = random_scene_rows(np.random.default_rng(100 + n), n)
    ref = tpu_rt.make_scene(**rows)
    ours = scene_from_numpy(np_fields(ref), CPU)
    attr = attribute_matrix(ours)
    assert attr.shape == (ref.capacity, 16)
    assert_ulps(attr, j_attribute_matrix(ref))
    # padding rows carry inv_radius 0, which the kernel masks on
    assert (attr[n:, 14] == 0).all()


def test_convert_round_trips_bit_equal():
    rows = random_scene_rows(np.random.default_rng(9), 13)
    scene = tpu_rt.make_scene(**rows)
    fields = np_fields(scene)
    back = scene_from_numpy(fields, CPU)
    for k, v in fields.items():
        o = as_np(getattr(back, k))
        assert o.dtype == v.dtype, k
        np.testing.assert_array_equal(o, v, err_msg=k)
    cam = tpu_rt.make_camera(**CAMERAS[2])
    cfields = np_fields(cam)
    cback = camera_from_numpy(cfields, CPU)
    for k, v in cfields.items():
        np.testing.assert_array_equal(as_np(getattr(cback, k)), v,
                                      err_msg=k)


def test_convert_camera_without_lens_fields():
    cam = tpu_rt.make_camera()._replace(aperture=None, focus_dist=None)
    back = camera_from_numpy(np_fields(cam), CPU)
    assert float(back.aperture) == 0.0 and float(back.focus_dist) == 0.0
