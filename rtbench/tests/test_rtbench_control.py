"""The comparison fails what it must: the control (the reference computed
in bfloat16, put in the program's place) and each fault planted under the
timed path, at a tiny size on the CPU; the card's look is skipped."""

import time

import pytest

from conftest import tiny_cell


TERRAIN_GRID = {"terrain10k.still": 8, "terrain10k.still-nee": 13}
# (cell, grid): the demo scene, and tiny terrains on K1 (8) and K2 (13)
SOUND = [("demo9.still", 8), ("terrain10k.still-nee", 8),
         ("terrain10k.still-nee", 13)]


@pytest.fixture(scope="module", params=SOUND, ids=lambda p: f"{p[0]}-{p[1]}")
def sound(request):
    from rtbench import check, harness

    cell = tiny_cell(*request.param)
    run, plan = harness.measure(cell, 901, 0.3, False, "cpu",
                                time.perf_counter())
    checks = check.judge(cell, plan, run.window.kept, run.port_segments,
                         "cpu")
    return cell, run, plan, checks


def test_sound_run_is_correct(sound):
    from rtbench import check

    assert check.correct(sound[3])


def test_the_control_fails(sound):
    from rtbench import check

    cell, run, plan, _ = sound
    gaps = check.control(cell, plan, run.window.kept, "cpu")
    assert not check.correct(gaps)
    assert gaps["acc_gap"]["value"] > 10 * cell.limits["acc_gap"]
    assert gaps["segments_gap"]["value"] > cell.limits["segments_gap"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", ["demo9.still", "spheres10k.still",
                                  "spheres10k.view", "terrain10k.still",
                                  "terrain10k.still-nee"])
def test_each_fault_fails(fault, name):
    from rtbench import check, faults, harness

    # terrains two bounces deep: on K1 (grid 8) without NEE, on K2 (grid
    # 13) with it
    cell = (tiny_cell(name, TERRAIN_GRID[name], max_depth=2)
            if name in TERRAIN_GRID else tiny_cell(name))
    run, plan = harness.measure(cell, 17, 0.3, False, "cpu",
                                time.perf_counter(),
                                fault=faults.FAULTS[fault])
    checks = check.judge(cell, plan, run.window.kept, run.port_segments,
                         "cpu")
    assert not check.correct(checks), checks
