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

# configurations that no cell of BENCHMARK.json runs yet, as a
# configuration file would state them: the project's large-mesh row
# (BASELINE.md, Large-scene scaling, "terrain 10,082 tris": terrain_mesh(
# n=72, seed=1), camera (0,6,6) -> (0,0,-10), benchmarks/bench_scenes.py)
CONFIGS = {
    "terrain10k": {
        "name": "terrain10k",
        "source": "https://github.com/Samuel-2000/PGR-Raytracing-Project",
        "what": "A heightfield of 10,082 triangles under three spheres, "
                "one of them emissive.",
        "engine": "cluster",
        "mode": "v2",
        "precision": "float32 geometry; bfloat16 shading attributes and "
                     "face normals, as the cluster engine's tables hold "
                     "them",
        "reduced": [],
        "scene": {"kind": "terrain", "n": 72, "extent": 12.0, "seed": 1},
        "camera": {"position": [0.0, 6.0, 6.0], "target": [0.0, 0.0, -10.0],
                   "up": [0.0, 1.0, 0.0], "fov": 45.0},
    },
}


def config(name: str) -> dict:
    """Configuration ``name``: of ``configs/`` or of CONFIGS."""
    from rtbench import spec

    if name in CONFIGS:
        return CONFIGS[name]
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def make_cell(name: str, limits: dict | None = None):
    """Cell ``name`` ("<config>.<traffic>") of BENCHMARK.json, or else of
    a configuration of ``configs/`` or CONFIGS under a mix of
    ``traffic/``, with ``limits`` (default LIMITS)."""
    from rtbench import spec

    try:
        return spec.cell(name)
    except KeyError:
        conf, mix = name.split(".", 1)
        return spec.Cell(name, config(conf),
                         spec.load_json(spec.HERE / "traffic" / f"{mix}.json"),
                         dict(limits or LIMITS), 1, [], [])


def tiny_cell(name: str, grid: int = 8, **traffic):
    """Cell ``name`` (as :func:`make_cell` finds it) at a size the CPU
    runs in a second or two: 128 x 64 pixels (two tiles of either engine),
    2 samples a batch, 2 batches a unit; in place of 10,000 spheres a field
    of 200 that fills the frame of a nearer camera; in place of a terrain
    of 10,082 triangles one of ``grid`` x ``grid`` vertices (8: 98
    triangles, on the megakernel; 13: 288, on the cluster engine), seen
    from nearer."""
    c = make_cell(name)
    tr = dict(c.traffic, width=128, height=64, spp=2, max_depth=3,
              batches_per_unit=2, pull_every=1, warmup_units=1,
              trace_seconds=0.2, check={"units": 2, "tiles": 1})
    tr.update(traffic)
    config = dict(c.config)
    if config["scene"]["kind"] == "random_spheres":
        config["scene"] = dict(config["scene"], n=200, spread=4.0)
        config["camera"] = dict(config["camera"], position=[0.0, 2.0, 4.0],
                                target=[0.0, 0.0, -4.0])
    if config["scene"]["kind"] == "terrain":
        config["scene"] = dict(config["scene"], n=grid)
        config["engine"] = ("pallas" if 2 * (grid - 1) ** 2 <= 256
                            else "cluster")
        config["camera"] = dict(config["camera"], position=[0.0, 3.5, 0.0],
                                target=[0.0, 1.0, -10.0])
    return dataclasses.replace(c, traffic=tr, config=config)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
