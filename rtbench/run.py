"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets the cell up (imports, the card, the
kernels' build, the scene, a warm-up of the cell's own shapes), measures
for ``--seconds`` seconds, checks what the timed path produced against the
plain reference (``rtbench/reference.py``) and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the trace's breakdown. It exits with another code
than 0, and prints no result, without a CUDA card, or when JAX or the JAX
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rtbench import check, harness, spec, stats  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_rt")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def end_to_end(cell, run) -> dict:
    w = run.window
    values = {
        "msamples_per_s": w.samples / w.seconds / 1e6,
        "setup_s": run.setup_s,
    }
    if w.first_s:
        values["first_ms_p95"] = 1e3 * stats.percentile(w.first_s, 95)
        values["view_ms_p95"] = 1e3 * stats.percentile(w.view_s, 95)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, run) -> dict:
    w = run.window
    r = SimpleNamespace(timeline=w.timeline, batches_traced=w.batches_traced,
                        enqueue_s=w.enqueue_s, ops_per_batch=run.ops_per_batch,
                        bytes_per_batch=run.bytes_per_batch)
    out = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"])(r)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(cell, run, checks: dict, trace_on: bool, device) -> dict:
    """The result line's object."""
    import torch

    w = run.window
    ok = check.correct(checks)
    per_unit = cell.traffic["batches_per_unit"]
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": run.device_kind, "count": run.device_count,
           "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": ok, "attempted": w.batches,
           "failed": 0 if ok else per_unit * max(1, len(w.kept)),
           "metrics": per_layer(cell, run) if trace_on
           else end_to_end(cell, run),
           "device": dev}
    if trace_on:
        dev["busy_s"] = w.timeline.busy_s
        dev["window_s"] = w.timeline.window_s
        from rtbench import trace

        out["breakdown"] = trace.breakdown(w.timeline)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    run, plan = harness.measure(cell, args.seed, args.seconds,
                                bool(args.trace), device, T_PROCESS)
    # the configuration's engine ran its kernel for every batch
    k1, k2 = run.window.launches
    print(f"rtbench: kernel launches in the window: K1 {k1}, K2 {k2} for "
          f"{run.window.batches} batches", file=sys.stderr)
    if (k1, k2)[cell.config["engine"] == "cluster"] < run.window.batches:
        raise RuntimeError(f"the {cell.config['engine']} engine did not "
                           "launch its kernel for every batch")
    t_check = time.perf_counter()
    checks = check.judge(cell, plan, run.window.kept, run.port_segments,
                         device)
    stamps = ", ".join(f"{k} {v:.3f}" for k, v in run.setup_stamps)
    print(f"rtbench: {args.workload} seed {args.seed}: setup "
          f"{run.setup_s:.3f} s ({stamps}), window {run.window.seconds:.3f} s, "
          f"{run.window.batches} batches, {run.window.units} units; check "
          f"{time.perf_counter() - t_check:.3f} s over "
          f"{len(run.window.kept)} units", file=sys.stderr)
    out = result(cell, run, checks, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"rtbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
