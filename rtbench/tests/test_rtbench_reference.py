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
    return ref.Spheres(arrays, engine, "cpu")


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


def test_grouped_search_equals_every_pair(monkeypatch):
    from rtbench import scenes

    arrays = scenes.random_spheres(600, 1, 30.0, 0.1)
    arrays["background"] = np.zeros(3, np.float32)
    sc = ref.Spheres(arrays, "cluster", "cpu")
    g = torch.Generator().manual_seed(0)
    n = 4000
    o = [torch.rand(n, generator=g) * 60 - 30, torch.rand(n, generator=g) * 6,
         torch.rand(n, generator=g) * 40 - 34]
    d = torch.randn(3, n, generator=g) * torch.tensor([[1.0], [0.2], [1.0]])
    d = list(d / torch.sqrt((d * d).sum(0)))
    t_edge = torch.rand(n, generator=g) * 20
    grouped = sc.nearest(o, d), sc.occluded(o, d, t_edge)
    monkeypatch.setattr(ref, "DENSE_MAX", 10**9)
    dense = sc.nearest(o, d), sc.occluded(o, d, t_edge)
    assert int((grouped[0][1] >= 0).sum()) > n // 10
    assert torch.equal(grouped[0][0], dense[0][0])
    assert torch.equal(grouped[0][1], dense[0][1])
    assert torch.equal(grouped[1], dense[1])
