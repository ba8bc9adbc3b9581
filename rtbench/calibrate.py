"""Readings that the comparison's limits are set from, on the card, in one
process:

    python3 rtbench/calibrate.py --workload <cell> --seeds 12 --seconds 3 \\
        [--control 3] [--faults 3] [--first-seed N]

For each seed a short run of the cell at its own size and load, judged as
a run judges it (the sound readings); on the first ``--control`` seeds
also the control, the reference computed in bfloat16 in the program's
place, judged by the cell's limits as a run is judged (``correct`` has to
come out false); on the first ``--faults`` seeds each planted fault of
``faults.py``. One JSON line per reading. Not run by the benchmark's own
runs.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rtbench import check, faults, harness, spec  # noqa: E402


def reading(cell, seed, seconds, device, fault=None, with_control=False):
    t0 = time.perf_counter()
    run, plan = harness.measure(cell, seed, seconds, False, device,
                                time.perf_counter(),
                                fault=faults.FAULTS.get(fault))
    checks = check.judge(cell, plan, run.window.kept, run.port_segments,
                         device)
    out = {"cell": cell.name, "seed": seed, "fault": fault,
           "correct": check.correct(checks),
           "numbers": {k: c["value"] for k, c in checks.items()},
           "units": len(run.window.kept), "batches": run.window.batches,
           "msamples_per_s": run.window.samples / run.window.seconds / 1e6}
    if with_control:
        t1 = time.perf_counter()
        ctl = check.control(cell, plan, run.window.kept, device)
        out["control_s"] = time.perf_counter() - t1
        out["control"] = {k: c["value"] for k, c in ctl.items()}
        out["control_correct"] = check.correct(ctl)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        print(json.dumps(reading(cell, seed, args.seconds, device,
                                 with_control=i < args.control)), flush=True)
    for seed in seeds[:args.faults]:
        for name in faults.FAULTS:
            print(json.dumps(reading(cell, seed, args.seconds, device,
                                     fault=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
