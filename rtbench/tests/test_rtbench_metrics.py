"""The benchmark's metric arithmetic on known inputs."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from rtbench import check, roofline, spec, stats, trace


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    xs = list(rng.uniform(size=37))
    for q in (0, 5, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q),
                                                        abs=1e-15)


def test_busy_and_gaps():
    iv = [(5, 6), (0, 2), (1, 3)]
    assert stats.merged_busy(iv) == 4
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert stats.gaps(iv, -1, 1.5) == [(-1, 0)]


def test_search_and_batch_ops():
    assert roofline.search_ops(1) == 24
    assert roofline.search_ops(9) == min(9 * 24, 4 * 26 + 2 * 24) == 152
    assert roofline.search_ops(10000) == 14 * 26 + 2 * 24 == 412
    # 100 segments, 10 pixels x 2 samples, 9 spheres
    plain = 100 * 152 + 80 * 62 + 20 * 33 + 10 * 15
    assert roofline.batch_ops(100, 10, 2, 9, False) == plain == 20970
    # with NEE the cheaper split (no shadow segment) bounds it
    assert roofline.batch_ops(100, 10, 2, 9, True) == plain
    assert roofline.batch_bytes(10, 9) == 9 * 64 + 64 + 120
    assert roofline.bound_s(67e12, 0) == (1.0, "operations")
    assert roofline.bound_s(0, 3.35e12) == (1.0, "bytes")


def _search_before(n_prims):
    """search_ops before triangles were counted, kept to pin it."""
    n = max(1, int(n_prims))
    levels = math.ceil(math.log2(n)) if n > 1 else 0
    return min(n * 24, levels * 26 + 2 * 24)


def _batch_ops_before(segments, n_pix, spp, n_prims, nee):
    rays = n_pix * spp
    search = _search_before(n_prims)

    def cost(shadow):
        path = segments - shadow
        return (path * search + max(path - rays, 0) * 62
                + shadow * (search + 120) + rays * 33 + n_pix * 15)

    return min(cost(0), cost(segments // 2)) if nee else cost(0)


# (n_pix, spp, spheres, nee) of demo9.still, spheres10k.still and
# demo9.still-nee
CELL_INPUTS = [(1920 * 1080, 256, 9, False), (1920 * 1080, 256, 10000, False),
               (1920 * 1080, 256, 9, True)]


def test_sphere_scenes_count_as_before_triangles():
    for n_pix, spp, n, nee in CELL_INPUTS:
        rays = n_pix * spp
        for segs in (rays, rays + 1, 2 * rays + 12345, 5 * rays + 7,
                     int(2.61 * rays), 8 * rays):
            want = _batch_ops_before(segs, n_pix, spp, n, nee)
            assert roofline.batch_ops(segs, n_pix, spp, n, nee) == want
            assert roofline.batch_ops(segs, n_pix, spp, n, nee, 0) == want
        assert roofline.batch_bytes(n_pix, n) == roofline.batch_bytes(
            n_pix, n, 0) == n * 64 + 64 + n_pix * 12
    for n in list(range(0, 300)) + [1023, 1024, 1025, 10000, 10**5, 10**6]:
        assert roofline.search_ops(n) == roofline.search_ops(n, 0) == \
            _search_before(n)


def test_triangles_in_the_search_and_the_bytes():
    assert roofline.TRI_TEST_OPS == 52
    # the terrain: 3 spheres and 10,082 triangles, a hierarchy of 14
    # levels over 10,085 primitives and two triangle tests at its leaf
    assert roofline.search_ops(3, 10082) == 14 * 26 + 2 * 52 == 468
    # the Cornell box: 2 spheres, 12 triangles; a flat sweep of 2 x 24 +
    # 12 x 52 = 672 costs more than 4 levels and 2 triangle tests
    assert roofline.search_ops(2, 12) == 4 * 26 + 2 * 52 == 208
    assert roofline.search_ops(0, 1) == 52 and roofline.search_ops(1, 1) == 76
    assert roofline.batch_ops(100, 10, 2, 2, False, 12) == (
        100 * 208 + 80 * 62 + 20 * 33 + 10 * 15)
    assert roofline.batch_bytes(10, 3, 100) == 3 * 64 + 100 * 64 + 64 + 120


def _timeline():
    tl = trace.Timeline(start=0.0, end=10000.0)
    tl.device = [("void megakernel<false, false, false, false>", 0.0, 2000.0),
                 ("Memcpy DtoH (Device -> Pageable)", 2500.0, 3000.0),
                 ("void megakernel<false, false, false, false>", 4000.0,
                  6000.0)]
    tl.spans = [("rtbench.render_device", 1000.0, 2200.0),
                ("rtbench.pull", 2300.0, 3900.0)]
    tl.ops = [("rtbench.pull", "aten::copy_", 2400.0, 3800.0)]
    return tl


def _readings(**kw):
    base = dict(timeline=_timeline(), batches_traced=2, enqueue_s=[],
                ops_per_batch=0.5e-3 * 67e12, bytes_per_batch=0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_on_a_known_timeline():
    r = _readings(enqueue_s=[0.001 * i for i in range(1, 22)])
    read = {m: spec.reader(m)(r) for m in (
        "k1_ms", "k2_ms", "nonkernel_ms", "device_idle", "k1_roofline",
        "step_mfu", "enqueue_ms", "k2_roofline")}
    assert read["k1_ms"] == pytest.approx(2.0)
    assert read["k2_ms"] is None and read["k2_roofline"] is None
    assert read["nonkernel_ms"] == pytest.approx(0.25)
    assert read["device_idle"] == pytest.approx(100 * (1 - 4.5 / 10))
    assert read["k1_roofline"] == pytest.approx(25.0)
    assert read["step_mfu"] == pytest.approx(100 * 2 * 0.5e-3 / 0.01)
    assert read["enqueue_ms"] == pytest.approx(11.0)
    assert spec.reader("enqueue_ms")(_readings(enqueue_s=[0.1] * 19)) is None
    assert spec.reader("device_idle")(_readings(timeline=None)) is None


def test_breakdown_labels_idle_time_by_host_activity():
    b = trace.breakdown(_timeline())
    assert b["device_ops"][0] == ["void megakernel<false, false, false, false>",
                                  pytest.approx(0.004)]
    idle = dict(b["idle_gaps"])
    assert idle["pull/aten::copy_"] == pytest.approx(0.001)
    assert idle["python"] == pytest.approx(0.0005 + 0.004)


def test_scaled_segments_as_the_program_reports_them():
    scale = np.float32(1920 * 1080 / (507 * 4096))
    assert check.scaled_segments(4096 * 50, "pallas", 1920, 1080) == int(
        np.float32(4096 * 50) * scale)
    assert check.scaled_segments(777, "cluster", 640, 480) == 777
    assert check.segments_gap(790, 800, "cluster", 640, 480) == 10 / 800


def test_every_metric_has_a_reader_and_every_cell_its_files():
    bench = spec.benchmark()
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert set(cell.limits) == set(check.NUMBERS)
