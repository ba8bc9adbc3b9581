"""The plain reference against cases worked out by hand."""

import math

import numpy as np
import pytest
import torch

from rtbench import reference as ref


def _murmur(mix, salt):
    """The counter hash in Python integers, written from its definition."""
    h = (mix + salt * 40503) % 2**32
    h ^= h >> 16
    h = (h * 2246822507) % 2**32
    h ^= h >> 13
    h = (h * 3266489909) % 2**32
    h ^= h >> 16
    return (h >> 8) / 16777216.0


def test_hash_and_batch_seeds():
    mixes = [0, 1, 12345, 2**32 - 1, 2**31 + 7]
    got = ref.uniform(torch.tensor(mixes, dtype=torch.int64), 3)
    assert got.tolist() == [np.float32(_murmur(m, 3)) for m in mixes]
    a = torch.tensor([3, 2**32 - 1], dtype=torch.int64)
    assert ref.mul32(a, 2654435769).tolist() == [
        (3 * 2654435769) % 2**32, ((2**32 - 1) * 2654435769) % 2**32]
    assert ref.batch_seed(0, 0) == 1000003
    assert ref.batch_seed(2**31 - 2, 5) == ((2**31 - 1) * 1000003 + 5) % 2**31


def _scene(rows, background=(0.25, 0.25, 0.25), engine="pallas"):
    rows = np.asarray(rows, np.float32).reshape(-1, 12)
    arrays = {"center": rows[:, 0:3], "radius": rows[:, 3],
              "albedo": rows[:, 4:7], "metallic": rows[:, 7],
              "roughness": rows[:, 8], "emission": rows[:, 9:12],
              "ior": np.full(len(rows), 1.5, np.float32),
              "background": np.asarray(background, np.float32)}
    return ref.Scene(arrays, engine, "cpu")


def test_nearest_hit_occlusion_and_ties():
    sc = _scene([[0, 0, -5, 1, .5, .5, .5, 0, 0, 0, 0, 0],
                 [0, 0, -5, 1, .5, .5, .5, 0, 0, 0, 0, 0],
                 [0, 0, -20, 2, .5, .5, .5, 0, 0, 0, 0, 0]])
    z = torch.zeros(3)
    o = (z, z, z)
    d = (z, z, torch.tensor([-1.0, 1.0, -1.0]))
    t, i = sc.nearest(o, d)
    assert t.tolist() == [4.0, ref.T_MAX, 4.0]
    assert i.tolist() == [0, -1, 0]  # equal roots: the first sphere wins
    occ = sc.occluded(o, d, torch.tensor([3.9, 100.0, 4.5]))
    assert occ.tolist() == [False, False, True]


def test_a_frame_that_only_misses_is_the_background():
    # one sphere behind the camera: every primary ray misses
    sc = _scene([[0, 0, 50, 1, .5, .5, .5, 0, 0, 9, 9, 9]])
    cam = ref.pack_camera({"position": [0, 0, 0], "target": [0, 0, -1],
                           "fov": 45.0}, 2.0, "cpu")
    for engine in ref.ENGINES:
        mean, x, y, segs = ref.render_tiles(sc, cam, engine, 1234, [1],
                                            width=128, height=64, spp=3,
                                            max_depth=4)
        assert mean.shape == (4096, 3) and torch.all(mean == 0.5)
        assert segs == 4096 * 3  # one segment a path, then it is gone


def test_inside_a_black_emitter_a_path_sees_its_emission():
    # the camera inside an emissive sphere of albedo 0: every path adds
    # the emission once, then carries nothing
    e = (0.25, 0.36, 0.49)
    sc = _scene([[0, 0, 0, 10, 0, 0, 0, 0, 0.5, *e]])
    cam = ref.pack_camera({"position": [0, 0, 0], "target": [0, 0, -1],
                           "fov": 45.0}, 2.0, "cpu")
    mean, *_ = ref.render_tiles(sc, cam, "pallas", 7, [0], width=128,
                                height=64, spp=2, max_depth=3)
    want = [math.sqrt(np.float32(v)) for v in e]
    assert mean.numpy() == pytest.approx(np.tile(want, (4096, 1)), abs=1e-7)


def test_pixels_of_whole_tiles():
    x, y, t = ref.tile_pixels("pallas", [1], 1920, 1080, "cpu")
    assert (y * 1920 + x).tolist() == list(range(4096, 8192))
    x, y, t = ref.tile_pixels("cluster", [16], 1920, 1080, "cpu")
    # block 16 of 15 a row: the second row of blocks, second column
    assert x.min() == 128 and x.max() == 255
    assert y.min() == 32 and y.max() == 63 and t.unique().tolist() == [16]
    assert ref.tile_grid("pallas", 1920, 1080) == (507, 506)
    assert ref.tile_grid("cluster", 1920, 1080) == (510, 495)


def test_accumulation_and_display():
    ones = torch.ones((4, 3))
    acc, n = ref.accumulate(None, 0, ones, 16)
    acc, n = ref.accumulate(acc, n, torch.zeros((4, 3)), 16)
    assert n == 32 and torch.all(acc == 0.5)
    stack = ref.display_stack(torch.ones((2, 2, 3)), 1.5)
    # 1.5 / 2.5 = 0.6, 0.6 * 255 = 153; a flat image is not stretched
    assert stack.dtype == torch.uint8 and stack.shape == (2, 2, 2, 3)
    assert torch.all(stack == 153)
    ramp = torch.linspace(0.0, 4.0, 300).reshape(10, 10, 3)
    s = ref.display_stack(ramp, 1.5)
    assert s[1].min() == 0 and s[1].max() == 255 and s[0].max() < 255


def test_camera_basis_by_hand():
    cam = ref.pack_camera({"position": [0, 2, 5], "target": [0, 0, -1],
                           "fov": 45.0}, 4 / 3, "cpu")
    fwd = np.array([0, -2, -6]) / math.sqrt(40)
    assert cam[3:6].numpy() == pytest.approx(fwd, abs=1e-7)
    assert cam[6:9].numpy() == pytest.approx([1, 0, 0], abs=1e-7)
    tf = math.tan(45.0 * 3.14159 / 360.0)
    assert float(cam[13]) == pytest.approx(tf, rel=1e-6)
    assert float(cam[12]) == pytest.approx(tf * 4 / 3, rel=1e-6)
    assert float(cam[15]) == pytest.approx(math.sqrt(40), rel=1e-7)


def _search_scene(kind):
    """Spheres (the random field), triangles (a terrain and its three
    spheres) or both, past DENSE_MAX of each."""
    from rtbench import scenes

    field = scenes.random_spheres(600, 1, 30.0, 0.1)
    land = scenes.terrain(13, 12.0, 1)
    if kind == "spheres":
        arrays = dict(field)
    elif kind == "triangles":
        arrays = dict(land)
    else:
        arrays = {k: np.concatenate([field[k], land[k]])
                  for k in scenes.FIELDS}
        arrays["mesh"] = land["mesh"]
    arrays["background"] = np.zeros(3, np.float32)
    return ref.Scene(arrays, "cluster", "cpu")


@pytest.mark.parametrize("kind", ["spheres", "triangles", "both"])
def test_grouped_search_equals_every_pair(monkeypatch, kind):
    sc = _search_scene(kind)
    g = torch.Generator().manual_seed(0)
    n = 4000
    o = [torch.rand(n, generator=g) * 60 - 30, torch.rand(n, generator=g) * 6,
         torch.rand(n, generator=g) * 40 - 34]
    d = torch.randn(3, n, generator=g) * torch.tensor([[1.0], [0.2], [1.0]])
    d[1] -= 0.1  # towards the terrain
    d = list(d / torch.sqrt((d * d).sum(0)))
    t_edge = torch.rand(n, generator=g) * 20
    grouped = sc.nearest(o, d), sc.occluded(o, d, t_edge)
    monkeypatch.setattr(ref, "DENSE_MAX", 10**9)
    dense = sc.nearest(o, d), sc.occluded(o, d, t_edge)
    hits = grouped[0][1][grouped[0][1] >= 0]
    assert hits.numel() > n // 10
    if kind != "spheres":
        assert int((hits >= sc.n_spheres).sum()) > n // 40
    assert torch.equal(grouped[0][0], dense[0][0])
    assert torch.equal(grouped[0][1], dense[0][1])
    assert torch.equal(grouped[1], dense[1])

def _mesh_scene(spheres, faces, engine="pallas", background=(0.25,) * 3,
                emission=None, albedo=0.5):
    """Sphere rows as ``_scene`` takes them, beside triangles (F, 3, 3)."""
    rows = np.asarray(spheres, np.float32).reshape(-1, 12)
    v = np.asarray(faces, np.float32).reshape(-1, 3, 3)
    f = v.shape[0]
    mesh = {"vertices": v, "albedo": np.full((f, 3), albedo, np.float32),
            "metallic": np.zeros(f, np.float32),
            "roughness": np.full(f, 0.5, np.float32),
            "emission": (np.zeros((f, 3), np.float32) if emission is None
                         else np.asarray(emission, np.float32)),
            "ior": np.full(f, 1.5, np.float32),
            "object_id": np.zeros(f, np.int32)}
    arrays = {"center": rows[:, 0:3], "radius": rows[:, 3],
              "albedo": rows[:, 4:7], "metallic": rows[:, 7],
              "roughness": rows[:, 8], "emission": rows[:, 9:12],
              "ior": np.full(len(rows), 1.5, np.float32),
              "background": np.asarray(background, np.float32),
              "mesh": mesh}
    return ref.Scene(arrays, engine, "cpu")


# two triangles that share the edge y = 0, z = -5 (above, below), and the
# same two in the other order
UPPER = [[-1, 0, -5], [1, 0, -5], [0, 1, -5]]
LOWER = [[-1, 0, -5], [1, 0, -5], [0, -1, -5]]


def _rays(*dirs):
    d = torch.tensor(dirs, dtype=torch.float32)
    d = d / torch.sqrt((d * d).sum(1, keepdim=True))
    z = torch.zeros(d.shape[0])
    return (z, z, z), tuple(d.unbind(1))


def test_triangle_hit_miss_back_face_and_ties():
    far = [90, 90, 90, 1, .5, .5, .5, 0, 0, 0, 0, 0]  # off every ray
    sc = _mesh_scene([far], [UPPER, LOWER])
    o, d = _rays([0, 0.5, -5], [0, 3, -5], [0, 0, -1], [0, 0, 1])
    t, i = sc.nearest(o, d)
    # a hit inside the upper triangle, a miss above it, a ray along the
    # shared edge (both give t = 5 with v = 0: the first triangle wins),
    # and a ray away from both
    assert i.tolist() == [1, -1, 1, -1]
    assert t[2].item() == 5.0 and t[1].item() == ref.T_MAX
    assert sc.face_normal(i)[0].tolist() == [True, False, True, False]
    swapped = _mesh_scene([far], [LOWER, UPPER])
    assert swapped.nearest(o, d)[1].tolist() == [2, -1, 1, -1]
    # a sphere whose root is also 5 wins over both triangles
    tie = [0, 0, -6, 1, .5, .5, .5, 0, 0, 0, 0, 0]
    both = _mesh_scene([far, tie], [UPPER, LOWER])
    t, i = both.nearest(o, d)
    assert t[2].item() == 5.0 and i[2].item() == 1
    # seen from behind (the triangle wound the other way) it is still hit
    back = _mesh_scene([far], [[UPPER[0], UPPER[2], UPPER[1]]])
    assert back.nearest(o, d)[1].tolist() == [1, -1, 1, -1]


def test_a_triangle_blocks_a_shadow_ray():
    far = [90, 90, 90, 1, .5, .5, .5, 0, 0, 0, 0, 0]
    sc = _mesh_scene([far], [UPPER])
    o, d = _rays([0, 0.5, -5], [0, 0.5, -5], [0, 3, -5])
    edge = torch.tensor([6.0, 4.9, 100.0])
    assert sc.occluded(o, d, edge).tolist() == [True, False, False]


@pytest.mark.parametrize("engine", ref.ENGINES)
def test_a_back_face_shades_with_its_normal_turned_to_the_ray(engine):
    # a diffuse triangle whose face normal points away from the camera;
    # a black sphere fills the space behind it. Turned to the ray, the
    # normal sends every bounce back to the camera's side, to the
    # background (1): each path carries 0.5 x 1. Unturned, every bounce
    # would end in the black sphere.
    big = [[-50, -50, -5], [0, 50, -5], [50, -50, -5]]
    black = [0, 0, -1000, 990, 0, 0, 0, 0, 0, 0, 0, 0]
    sc = _mesh_scene([black], [big], engine, background=(1, 1, 1))
    cam = ref.pack_camera({"position": [0, 0, 0], "target": [0, 0, -1],
                           "fov": 45.0}, 2.0, "cpu")
    mean, *_ = ref.render_tiles(sc, cam, engine, 99, [0], width=128,
                                height=64, spp=2, max_depth=2)
    assert torch.all(mean == np.sqrt(np.float32(0.5)))


def _lights(emissions, engine, radius=0.5):
    rows = [[3 * k, 0, -5, radius, .5, .5, .5, 0, 0, *e]
            for k, e in enumerate(emissions)]
    return _scene(rows, engine=engine)


def test_light_tables_by_hand():
    u = torch.tensor([1e-6, 0.3, 0.6, 0.999])
    # twelve spheres, the first dark and the others emissive: the
    # megakernel draws among all eleven lights, the cluster engine among
    # the first eight (spheres 1-8) alone
    em = [(0, 0, 0)] + [(k, 1, 1) for k in range(1, 12)]
    for engine, n in (("pallas", 11), ("cluster", 8)):
        sc = _lights(em, engine)
        assert sc.n_lights.item() == n
        cx, *_, er, _, _ = sc.pick_light(u)
        want = [1 + int(np.ceil(x * n) - 1) for x in u.tolist()]
        assert er.tolist() == want
        assert cx.tolist() == [3.0 * k for k in want]
    # none: no light, every draw picks the zero row
    for engine in ref.ENGINES:
        sc = _lights([(0, 0, 0)] * 3, engine)
        assert sc.n_lights.item() == 0
        assert all(torch.all(p == 0) for p in sc.pick_light(u))
    # one light behind a dark sphere: the cluster table puts it first and
    # holds its emission in float32 (1/3 is not a bfloat16), the dark
    # sphere after it with radius 0
    sc = _lights([(0, 0, 0), (1 / 3, 2, 2)], "cluster")
    assert sc.n_lights.item() == 1
    assert sc.lights[:, 3].tolist() == [0.5, 0.0]
    cx, _, _, r, er, _, _ = sc.pick_light(u)
    assert cx.tolist() == [3.0] * 4 and r.tolist() == [0.5] * 4
    assert er.tolist() == [np.float32(1 / 3)] * 4
    assert sc.shading[1, 5].item() != np.float32(1 / 3)  # bfloat16 shading
