"""First-hit AOVs in the port (tpu_rt_torch/render/aov.py, with the dense
sweeps of ops/intersect.py and ops/triangle.py) against the JAX package's,
on the CPU, at 64x48: the demo scene and the Cornell box mesh, and the
joint bilateral fed those AOVs.

The two packages do not round alike here: XLA:CPU contracts a * b + c into
an FMA and approximates rsqrt, the port rounds every product and divides.
Rays and hit parameters therefore differ in their last bits, which the
ground sphere (radius 1000, its quadratic cancels) and grazing hits
amplify. So where both packages see the same surface, albedo is held
equal, depth to a relative 5e-5 and the normal to 5e-4 (measured: 1.3e-5
and 1.3e-4); the hit mask may differ at 0.1% of the pixels, and the object
id only where two surfaces lie at one depth (a corner of the box's walls).
One JAX compile serves all cases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpu_rt
from tpu_rt.core import scenes as j_scenes
from tpu_rt.ops import post as jpost
from tpu_rt.render.aov import render_aovs as j_render_aovs

import tpu_rt_torch
from tpu_rt_torch.core import scenes
from tpu_rt_torch.ops import post
from tpu_rt_torch.render.aov import render_aovs

torch.set_num_threads(1)
W, H = 64, 48
CPU = torch.device("cpu")
CORNELL_POSE = dict(position=(0, 2, 2.5), target=(0, 2, -3))
KEYS = {"normal", "depth", "albedo", "object_id", "hit"}
IMG = np.random.default_rng(23).uniform(0, 1, (H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    scene = tpu_rt.demo_scene()
    cam = tpu_rt.make_camera(aspect=W / H)
    c_scene, c_mesh = j_scenes.cornell_box()
    c_cam = tpu_rt.make_camera(aspect=W / H, **CORNELL_POSE)

    @jax.jit
    def fn(img, scene, cam, c_scene, c_cam, c_mesh):
        demo = j_render_aovs(scene, cam, width=W, height=H)
        box = j_render_aovs(c_scene, c_cam, width=W, height=H, mesh=c_mesh)
        joint = {name: jpost.joint_bilateral(img, a["normal"], a["depth"])
                 for name, a in (("demo", demo), ("cornell", box))}
        return {"demo": demo, "cornell": box}, joint

    aovs, joint = fn(jnp.asarray(IMG), scene, cam, c_scene, c_cam, c_mesh)
    return ({k: {n: np.array(v) for n, v in a.items()}
             for k, a in aovs.items()},
            {k: np.array(v) for k, v in joint.items()})


def port_aovs(name):
    if name == "demo":
        return render_aovs(tpu_rt_torch.demo_scene(device=CPU),
                           tpu_rt_torch.make_camera(aspect=W / H, device=CPU),
                           W, H)
    c_scene, c_mesh = scenes.cornell_box(device=CPU)
    cam = tpu_rt_torch.make_camera(aspect=W / H, device=CPU, **CORNELL_POSE)
    return render_aovs(c_scene, cam, W, H, mesh=c_mesh)


@pytest.mark.parametrize("name", ["demo", "cornell"])
def test_render_aovs_matches_jax(jax_side, name):
    ref = jax_side[0][name]
    ours = {k: v.numpy() for k, v in port_aovs(name).items()}
    assert set(ours) == set(ref) == KEYS
    for k in KEYS:
        assert ours[k].shape == ref[k].shape, k
        assert ours[k].dtype == ref[k].dtype, k
    hit_same = ours["hit"] == ref["hit"]
    assert hit_same.mean() >= 0.999
    assert 0.3 < ref["hit"].mean()  # the scene fills the frame in part
    same = hit_same & (ours["object_id"] == ref["object_id"])
    # another winner only where two surfaces lie at one depth
    tie = hit_same & ~same & ref["hit"]
    np.testing.assert_allclose(ours["depth"][tie], ref["depth"][tie],
                               rtol=1e-5)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(ours["albedo"][same], ref["albedo"][same])
    np.testing.assert_allclose(ours["depth"][same], ref["depth"][same],
                               rtol=5e-5)
    np.testing.assert_allclose(ours["normal"][same], ref["normal"][same],
                               rtol=0, atol=5e-4)
    miss = same & ~ref["hit"]
    assert (ours["depth"][miss] == np.float32(1e10)).all()
    assert (ours["object_id"][miss] == -1).all()
    assert not ours["normal"][miss].any()


@pytest.mark.parametrize("name", ["demo", "cornell"])
def test_joint_bilateral_on_the_aovs(jax_side, name):
    """The joint bilateral fed the JAX package's AOVs of each scene, misses
    (depth T_MAX, zero normal) included."""
    a = jax_side[0][name]
    ours = post.joint_bilateral(torch.from_numpy(IMG),
                                torch.from_numpy(a["normal"]),
                                torch.from_numpy(a["depth"])).numpy()
    np.testing.assert_allclose(ours, jax_side[1][name], rtol=0, atol=1e-5)
    # the geometry guides the filter: it differs from the plain bilateral
    assert not np.allclose(ours, post.bilateral_filter(
        torch.from_numpy(IMG)).numpy(), atol=1e-3)
