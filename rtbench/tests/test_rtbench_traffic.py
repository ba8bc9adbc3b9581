"""Every cell of BENCHMARK.json, and every traffic mix, run at a tiny size
through the program's plain path on the CPU and judged by the comparison:
sound runs are correct, the window produced whole units. So are tiny
terrains on either engine, with and without NEE."""

import json
import time

import pytest

from conftest import ROOT, make_cell, tiny_cell

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# the mixes no cell runs yet, on the configuration they were made for
MIXES = sorted(p.stem for p in (ROOT / "rtbench" / "traffic").glob("*.json"))
EXTRA = [f"spheres10k.{m}" for m in MIXES
         if not any(c.split(".", 1)[1] == m for c in CELLS)]


@pytest.mark.parametrize("name", CELLS + EXTRA)
def test_tiny_run_is_correct(name):
    from rtbench import check, harness

    cell = tiny_cell(name)
    run, plan = harness.measure(cell, 2**31 + 97, 0.3, True, "cpu",
                                time.perf_counter())
    w = run.window
    checks = check.judge(cell, plan, w.kept, run.port_segments, "cpu")
    assert check.correct(checks), checks
    assert checks["acc_gap"]["value"] == 0.0
    assert w.batches >= 1 and w.kept
    assert all(len(u.frames) == cell.traffic["batches_per_unit"]
               for u in w.kept)
    assert w.timeline is not None and w.timeline.window_s > 0.0
    if cell.traffic["kind"] == "view":
        assert len(w.first_s) == len(w.view_s) == w.units >= 1
        assert all(0.0 < f <= v for f, v in zip(w.first_s, w.view_s))


@pytest.mark.parametrize("mix", ["still", "still-nee"])
@pytest.mark.parametrize("grid", [8, 13])
def test_tiny_mesh_run_is_correct(grid, mix):
    """A terrain through RayTracer.set_mesh (8: K1-tri, 98 triangles; 13:
    K2-tri, 288), judged by the limits of spheres10k.still."""
    import dataclasses

    from rtbench import check, harness

    cell = dataclasses.replace(
        tiny_cell(f"terrain10k.{mix}", grid),
        limits=make_cell("spheres10k.still").limits)
    run, plan = harness.measure(cell, 2**31 + 501, 0.3, False, "cpu",
                                time.perf_counter())
    checks = check.judge(cell, plan, run.window.kept, run.port_segments,
                         "cpu")
    assert check.correct(checks), checks
    if cell.config["engine"] == "pallas":
        assert checks["acc_gap"]["value"] == 0.0


def test_plan_is_drawn_from_the_seed():
    from rtbench.traffic import Plan

    cell = tiny_cell("spheres10k.view")
    a, b, c = (Plan(cell.traffic, cell.config, s) for s in (11, 11, 2**33 + 5))
    assert a.tracer_seed == b.tracer_seed
    assert [a.camera(u) for u in range(5)] == [b.camera(u) for u in range(5)]
    assert a.camera(3) != c.camera(3)
    still = tiny_cell("demo9.still")
    p = Plan(still.traffic, still.config, -4)
    assert p.camera(0) == p.camera(9) == still.config["camera"]
    assert 0 <= p.tracer_seed < 2**31
