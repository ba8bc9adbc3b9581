"""A short run of each cell on the card, as the benchmark's command runs
it: ``python -m pytest -m cuda rtbench/tests``. Skips without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

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
