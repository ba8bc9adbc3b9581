"""The comparison that decides ``correct``.

For each checked unit (a still or a view drawn from the seed among those
the window produced) and each of its tiles drawn from the seed:

* ``acc_gap``: the mean absolute gap, over the tiles' pixels and
  channels, between the accumulator the timed path produced and the
  reference's accumulation of the same batches; the largest over units.
  It covers the kernel (K1 or K2), the per-batch mean and gamma, and the
  accumulation.
* ``display_gap``: the largest gap, in uint8 levels, between the display
  stack the timed path pulled last in the unit and the reference's display
  stack of that unit's accumulator (the one ``acc_gap`` judged), over
  every pixel of both rows: the tone map, the percentile stretch and the
  quantization.
* ``segments_gap``: the gap between the program's own count of the
  segments the first checked batch traces over the checked tiles (the
  count the rooflines take) and the reference's, as a share of the
  reference's.
* ``samples_gap``: the largest gap, over units, between the sample count
  that the accumulation returned with the unit's accumulator and the
  unit's batches x spp: an accumulation that keeps its state reads a
  batch short, however close its image.

Each has its limit in ``limits/<cell>.json``. The reference runs after
the window, once the program's state is freed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import reference, scenes

NUMBERS = ("acc_gap", "display_gap", "segments_gap", "samples_gap")


def reference_unit(sc: reference.Scene, cell, plan, unit):
    """The reference's (P, 3) accumulator of ``unit`` over its tiles, the
    pixels' x and y, and the segments of its first batch."""
    tr = plan.traffic
    cam = reference.pack_camera(unit.camera, tr["width"] / tr["height"],
                                sc.device, sc.dtype)
    seeds = [reference.batch_seed(plan.tracer_seed, f) for f in unit.frames]
    return reference.render_unit(
        sc, cam, cell.config["engine"], seeds, unit.tiles, width=tr["width"],
        height=tr["height"], spp=tr["spp"], max_depth=tr["max_depth"],
        nee=bool(tr["nee"]))


def scaled_segments(count: int, engine: str, width: int, height: int) -> int:
    """A count over whole tiles as the program reports it: scaled by the
    frame's real pixels over its traced lanes, in float32, truncated."""
    n_tiles, _ = reference.tile_grid(engine, width, height)
    scale = np.float32(width * height / (n_tiles * reference.TILE))
    return int(np.float32(count) * scale)


def segments_gap(count: int, ref_count: int, engine: str, width: int,
                 height: int) -> float:
    """|count - the reference's count, as reported| over the latter."""
    want = scaled_segments(ref_count, engine, width, height)
    return abs(count - want) / max(want, 1)


def acc_gap(acc_prog, ref_acc, x, y) -> float:
    got = acc_prog[y, x].to(torch.float64)
    gap = (got - ref_acc.to(torch.float64)).abs()
    if gap.max() > 0.0:
        print(f"rtbench: the accumulator differs in {int((gap > 0).sum())} "
              f"of {gap.numel()} values, by at most {float(gap.max())!r}",
              file=sys.stderr)
    return float(gap.mean())


def judge(cell, plan, units, port_segments: int, device) -> dict:
    """The numbers compared, each as {"value", "limit"}."""
    tr = plan.traffic
    sc = reference.Scene(scenes.scene_arrays(cell.config),
                         cell.config["engine"], device)
    acc_g, disp_g, seg_g, samp_g = 0.0, 0, None, 0
    want = tr["batches_per_unit"] * tr["spp"]
    for k, unit in enumerate(units):
        samp_g = max(samp_g, abs(int(unit.samples) - want))
        ref_acc, x, y, segs = reference_unit(sc, cell, plan, unit)
        acc_g = max(acc_g, acc_gap(unit.acc, ref_acc, x, y))
        ref_disp = reference.display_stack(unit.acc, tr["exposure"]).cpu()
        disp_g = max(disp_g, int((ref_disp.to(torch.int16) - torch.from_numpy(
            unit.display).to(torch.int16)).abs().max()))
        if k == 0:
            seg_g = segments_gap(port_segments, segs, cell.config["engine"],
                                 tr["width"], tr["height"])
    values = {"acc_gap": acc_g, "display_gap": disp_g, "segments_gap": seg_g,
              "samples_gap": samp_g}
    if not units:
        values = {k: None for k in NUMBERS}
    return {k: {"value": values[k], "limit": cell.limits[k]}
            for k in NUMBERS}


def control(cell, plan, units, device, dtype=torch.bfloat16) -> dict:
    """The control's ``acc_gap`` and ``segments_gap``, each as {"value",
    "limit"} like ``judge``'s: the reference computed in ``dtype``, the
    precision below the configuration's float32, put in the program's
    place for the same units and tiles. ``correct`` of it has to be
    false."""
    tr = plan.traffic
    arrays = scenes.scene_arrays(cell.config)
    engine = cell.config["engine"]
    exact = reference.Scene(arrays, engine, device)
    low = reference.Scene(arrays, engine, device, dtype)
    gaps = {"acc_gap": 0.0, "segments_gap": 0.0}
    for k, unit in enumerate(units):
        ref_acc, _, _, ref_segs = reference_unit(exact, cell, plan, unit)
        low_acc, _, _, low_segs = reference_unit(low, cell, plan, unit)
        gaps["acc_gap"] = max(gaps["acc_gap"], float(
            (low_acc.to(torch.float64) - ref_acc.to(torch.float64)).abs()
            .mean()))
        if k == 0:
            gaps["segments_gap"] = segments_gap(
                scaled_segments(low_segs, engine, tr["width"], tr["height"]),
                ref_segs, engine, tr["width"], tr["height"])
    return {k: {"value": v, "limit": cell.limits[k]} for k, v in gaps.items()}


def correct(checks: dict) -> bool:
    """Every number read and within its limit (a NaN is not)."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
