"""The benchmark's own tests: ``python -m pytest rtbench/tests`` from the
root of the repository (the card's tests: ``-m cuda``)."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


LIMITS = {"acc_gap": 1e-3, "display_gap": 0, "segments_gap": 1e-3,
          "samples_gap": 0}


def tiny_cell(name: str, **traffic):
    """Cell ``name`` ("<config>.<traffic>", of BENCHMARK.json or not) at a
    size the CPU runs in a second: 128 x 64 pixels (two tiles of either
    engine), 2 samples a batch, 2 batches a unit, and in place of 10,000
    spheres a field of 200 that fills the frame of a nearer camera."""
    from rtbench import spec

    try:
        c = spec.cell(name)
    except KeyError:
        config, mix = name.split(".", 1)
        c = spec.Cell(name, spec.load_json(spec.HERE / "configs" /
                                           f"{config}.json"),
                      spec.load_json(spec.HERE / "traffic" / f"{mix}.json"),
                      dict(LIMITS), 1, [], [])
    tr = dict(c.traffic, width=128, height=64, spp=2, max_depth=3,
              batches_per_unit=2, pull_every=1, warmup_units=1,
              trace_seconds=0.2, check={"units": 2, "tiles": 1})
    tr.update(traffic)
    config = dict(c.config)
    if config["scene"]["kind"] == "random_spheres":
        config["scene"] = dict(config["scene"], n=200, spread=4.0)
        config["camera"] = dict(config["camera"], position=[0.0, 2.0, 4.0],
                                target=[0.0, 0.0, -4.0])
    return dataclasses.replace(c, traffic=tr, config=config)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
