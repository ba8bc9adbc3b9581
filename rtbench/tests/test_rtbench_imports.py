"""What a run and its reference load, each in a fresh interpreter: no JAX,
no JAX package, and no module of the program in the reference."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ["flax", "jax", "jaxlib", "tpu_rt"]

BENCH = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'rtbench' / 'tests')!r})
from rtbench import calibrate, check, faults, harness, run, spec, trace
from conftest import tiny_cell
for m in spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
cell = tiny_cell("spheres10k.view")
r, plan = harness.measure(cell, 5, 0.2, True, "cpu", time.perf_counter())
check.judge(cell, plan, r.window.kept, r.port_segments, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
from rtbench import reference, scenes, spec
config = spec.load_json(spec.HERE / "configs" / "demo9.json")
sc = reference.Scene(scenes.scene_arrays(config), "pallas", "cpu")
cam = reference.pack_camera(config["camera"], 2.0, "cpu")
reference.render_unit(sc, cam, "pallas", [1, 2], [0], width=128, height=64,
                      spp=1, max_depth=2)
terrain = scenes.scene_arrays({{"scene": {{"kind": "terrain", "n": 13,
                                         "extent": 12.0, "seed": 1}}}})
sc = reference.Scene(terrain, "cluster", "cpu")
cam = reference.pack_camera({{"position": [0, 3.5, 0], "target": [0, 1, -10],
                             "fov": 45.0}}, 2.0, "cpu")
reference.render_unit(sc, cam, "cluster", [1], [0], width=128, height=64,
                      spp=1, max_depth=2, nee=True)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    tops = _modules(BENCH)
    assert "tpu_rt_torch" in tops
    assert not set(tops) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    tops = {m.split(".")[0] for m in mods}
    assert "torch" in tops
    assert not tops & set(FORBIDDEN + ["tpu_rt_torch"])
