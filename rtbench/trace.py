"""The traced slice of a run: a ``torch.profiler`` window over the first
seconds of the measured window, kept in memory and reduced to the device
timeline, the benchmark's own spans and the host operations inside them.

The spans are ``record_function`` ranges the harness opens around its
calls into each layer (``SPANS``); their names label the idle gaps of the
device timeline in the breakdown.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

from .stats import gaps, merged_busy

WINDOW = "rtbench.window"
SPANS = ("rtbench.set_camera", "rtbench.render_device", "rtbench.accumulate",
         "rtbench.display_stack", "rtbench.pull")
TOP = 10


def profiler():
    """A started profiler of host operations and the card's activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def span(name: str, on: bool):
    """A ``record_function`` range named ``name`` while tracing, else
    nothing."""
    if not on:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


@dataclass
class Timeline:
    """The traced slice, in microseconds of the profiler's clock."""

    device: list = field(default_factory=list)   # (name, start, end)
    spans: list = field(default_factory=list)    # (name, start, end)
    ops: list = field(default_factory=list)      # (span, op, start, end)
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return merged_busy([(s, e) for _, s, e in self.device]) * 1e-6

    def device_s(self, match) -> float:
        """Seconds of the device events whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) * 1e-6

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.device if match(n))


def short(name: str) -> str:
    """A device operation's name without namespaces' noise and its
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:160] or "(unnamed)"


def read(prof) -> Timeline:
    """The Timeline of a stopped profiler, from its raw events: the device
    operations (the device side of the benchmark's own ranges is none),
    the benchmark's spans and the host operations directly inside them."""
    from torch.autograd import DeviceType

    tl = Timeline()
    host = []
    for ev in prof.profiler.kineto_results.events():
        start, end = ev.start_ns() * 1e-3, ev.end_ns() * 1e-3
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                tl.device.append((name, start, end))
        elif name == WINDOW:
            tl.start, tl.end, thread = start, end, ev.start_thread_id()
        else:
            host.append((start, -end, name, ev.start_thread_id()))
    if tl.end <= tl.start:
        raise RuntimeError("the profiler recorded no traced window")
    # a host operation is directly inside a span when the innermost event
    # that holds it is the span
    open_ = []
    for start, neg_end, name, tid in sorted(host):
        if tid != thread:
            continue
        while open_ and open_[-1][1] <= start:
            open_.pop()
        if name in SPANS:
            tl.spans.append((name, start, -neg_end))
        elif open_ and open_[-1][0] in SPANS:
            tl.ops.append((open_[-1][0], name, start, -neg_end))
        open_.append((name, -neg_end))
    tl.device = [(n, max(s, tl.start), min(e, tl.end))
                 for n, s, e in tl.device if e > tl.start and s < tl.end]
    return tl


def _labeler(tl: Timeline):
    """A function from a time to what the host was doing then: the
    benchmark's span and the host operation inside it, or "python"."""
    spans = sorted(tl.spans, key=lambda x: x[1])
    ops = sorted(tl.ops, key=lambda x: x[2])
    span_starts = [s for _, s, _ in spans]
    op_starts = [s for _, _, s, _ in ops]

    def label(t):
        i = bisect.bisect_right(span_starts, t) - 1
        if i < 0 or spans[i][2] < t:
            return "python"
        j = bisect.bisect_right(op_starts, t) - 1
        if j >= 0 and ops[j][0] == spans[i][0] and ops[j][3] >= t:
            return f"{spans[i][0][8:]}/{ops[j][1]}"
        return spans[i][0][8:]

    return label


def breakdown(tl: Timeline) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, at most ``TOP`` entries each, in seconds."""
    by_op: dict = {}
    for n, s, e in tl.device:
        by_op[short(n)] = by_op.get(short(n), 0.0) + (e - s) * 1e-6
    label = _labeler(tl)
    by_host: dict = {}
    for a, b in gaps([(s, e) for _, s, e in tl.device], tl.start, tl.end):
        k = label(0.5 * (a + b))
        by_host[k] = by_host.get(k, 0.0) + (b - a) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
