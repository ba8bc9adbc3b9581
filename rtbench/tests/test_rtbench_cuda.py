"""A short run of each cell on the card, as the benchmark's command runs
it: ``python -m pytest -m cuda rtbench/tests``. Skips without a card."""

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT, make_cell

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(cuda_device, name):
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", name, "--seed",
         "2147483999", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483999, 3000000019])
def test_terrain10k_still_nee_is_correct_on_the_card(cuda_device, seed):
    """A mesh cell that BENCHMARK.json does not list: terrain_mesh(n=72)
    (10,082 triangles and 3 spheres) through RayTracer.set_mesh and the
    cluster engine with NEE, 1080p stills of 2 x 256 spp, a 10-s window,
    judged by spheres10k.still's limits. Prints what it measured."""
    import torch

    from rtbench import check, harness

    cell = make_cell("terrain10k.still-nee",
                     limits=make_cell("spheres10k.still").limits)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    run, plan = harness.measure(cell, seed, 10.0, False, cuda_device,
                                time.perf_counter())
    t0 = time.perf_counter()
    checks = check.judge(cell, plan, run.window.kept, run.port_segments,
                         cuda_device)
    w = run.window
    print("terrain10k.still-nee " + json.dumps({
        "seed": seed, "setup_s": run.setup_s, "window_s": w.seconds,
        "batches": w.batches, "units": w.units,
        "ms_per_batch": 1e3 * w.seconds / max(w.batches, 1),
        "msamples_per_s": w.samples / w.seconds / 1e6,
        "launches": w.launches, "memory_peak_bytes": run.memory_peak_bytes,
        "ops_per_batch": run.ops_per_batch,
        "bytes_per_batch": run.bytes_per_batch,
        "checks": {k: c["value"] for k, c in checks.items()},
        "check_s": time.perf_counter() - t0}), flush=True)
    assert w.launches[1] >= w.batches and w.launches[0] == 0
    assert check.correct(checks), checks
