"""The one traffic generator: a mix's data file and a configuration's
camera, turned into the plan of one run from its seed.

A mix (``traffic/<name>.json``) is a closed loop of one user. Its units
are stills (``kind: still``: the configuration's camera, batches
dispatched ahead, the display pulled every ``pull_every`` batches) or
views (``kind: view``: a camera move along an orbit around the
configuration's target, then ``batches_per_unit`` batches, each pulled).
The seed gives the tracer's seed, the orbit's phase and step jitter, and
the draws of the correctness check; every seed gives the same sizes and
the same kinds of work.
"""

from __future__ import annotations

import math

import numpy as np

KINDS = ("still", "view")
REQUIRED = ("kind", "width", "height", "spp", "max_depth", "nee", "exposure",
            "batches_per_unit", "pull_every", "warmup_units",
            "trace_seconds", "check")


def validate(traffic: dict) -> dict:
    """Raise unless the mix holds what the generator reads."""
    missing = [k for k in REQUIRED if k not in traffic]
    if missing:
        raise ValueError(f"traffic lacks {missing}")
    if traffic["kind"] not in KINDS:
        raise ValueError(f"traffic kind {traffic['kind']!r} not in {KINDS}")
    if traffic["batches_per_unit"] % traffic["pull_every"]:
        raise ValueError("batches_per_unit must be a multiple of pull_every, "
                         "so that a unit ends with a pulled display")
    if traffic["kind"] == "view" and "orbit" not in traffic:
        raise ValueError("a view mix needs its orbit")
    return traffic


class Plan:
    """What one run does, drawn from its seed (any integer)."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        self.traffic = validate(traffic)
        self.config = config
        streams = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(3)
        self.tracer_seed = int(np.random.default_rng(streams[0]).integers(
            0, 2**31 - 1))
        self._orbit_rng = np.random.default_rng(streams[1])
        self.check_rng = np.random.default_rng(streams[2])
        cam = config["camera"]
        px, py, pz = cam["position"]
        tx, ty, tz = cam["target"]
        self._radius = math.hypot(px - tx, pz - tz)
        self._angles = [math.atan2(px - tx, pz - tz)
                        + float(self._orbit_rng.uniform(0.0, 2.0 * math.pi))]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def camera(self, unit: int) -> dict:
        """The camera of unit ``unit`` (counting warm-up units from 0)."""
        cam = self.config["camera"]
        if self.kind == "still":
            return dict(cam)
        orbit = self.traffic["orbit"]
        while len(self._angles) <= unit:
            step = orbit["step_deg"] + orbit["step_jitter_deg"] * float(
                self._orbit_rng.uniform(-1.0, 1.0))
            self._angles.append(self._angles[-1] + math.radians(step))
        a = self._angles[unit]
        tx, ty, tz = cam["target"]
        return dict(cam, position=[tx + self._radius * math.sin(a),
                                   cam["position"][1],
                                   tz + self._radius * math.cos(a)])
