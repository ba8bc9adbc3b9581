"""Frame timing on the card, traced-ray throughput, the app's frame
counters, and the port's own spans and counters.

Counterpart of ``tpu_rt/utils/profiling.py``: :func:`sync` stands in for
its ``block_until_ready`` fence, :class:`FrameStats` is its rolling
counter, and :func:`torch_trace` a ``torch.profiler`` trace where it has
``xla_trace``. CUDA events time the card's frames (:func:`cuda_frame_ms`);
those device measurements raise on anything but a CUDA device instead of
timing a CPU run.

:func:`span` and :func:`count` are the one place the port traces itself:
a span is a range named ``tpu_rt_torch.<phase>`` on the profiler's host
clock, entered only while a ``torch.profiler`` records, and :func:`counts`
snapshots the counters (``uploads``: host data copied to a device;
``input_builds``: kernel inputs a RayTracer built, a pose's camera or a
scene's tables).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Callable, List

import torch


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x=None) -> None:
    """Wait until the card has finished the work queued for ``x`` (a
    tensor, or a dict, list or tuple holding tensors): synchronize each
    CUDA device it lies on. With no ``x``, the current CUDA device, when
    CUDA has been used. A no-op on the CPU, whose tensors are done when
    they are returned."""
    if x is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@dataclass
class FrameStats:
    """Rolling render statistics (Mrays/s, ms/frame)."""

    window: int = 32
    times: List[float] = field(default_factory=list)
    rays: List[int] = field(default_factory=list)

    def record(self, seconds: float, ray_segments: int):
        self.times.append(seconds)
        self.rays.append(ray_segments)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.rays.pop(0)

    @property
    def frame_ms(self) -> float:
        return 1e3 * (sum(self.times) / len(self.times)) if self.times else 0.0

    @property
    def mrays_per_s(self) -> float:
        t = sum(self.times)
        return (sum(self.rays) / t / 1e6) if t > 0 else 0.0

    def summary(self) -> str:
        return f"{self.frame_ms:.1f} ms/frame, {self.mrays_per_s:.1f} Mrays/s"


SPAN_PREFIX = "tpu_rt_torch."
_NULL = contextlib.nullcontext()
# name -> count since the process started, and the counts made since the
# profiler that records now started
_counts: dict = {}
_traced: dict = {}
_was_recording = False
_batch = None  # the batch number the last span was given


def _recording() -> bool:
    """Whether a profiler records now; the first call that sees one start
    clears the traced counts, so they are of its window alone (a profiler
    started right after another, with no span, count or snapshot between
    them, adds to the last one's)."""
    global _was_recording
    on = torch.autograd._profiler_enabled()
    if on and not _was_recording:
        _traced.clear()
    _was_recording = on
    return on


def span(phase: str, batch: int | None = None):
    """The range ``tpu_rt_torch.<phase>`` while a profiler records, else a
    shared null context that enters nothing.

    It carries a batch number as its keyword ``batch``: ``batch``, or the
    one the last span was given, so the spans of a RayTracer batch share
    the batch number its first span names. A trace that records shapes
    (:func:`torch_trace`) writes it into the event's args. The range is a
    RecordFunction entered through torch's ``_RecordFunctionFast``, whose
    keyword values reach such a trace; ``record_function`` writes its
    ``args`` string nowhere."""
    global _batch
    if not _recording():
        return _NULL
    if batch is not None:
        _batch = batch
    return torch._C._profiler._RecordFunctionFast(
        SPAN_PREFIX + phase, (), {} if _batch is None else {"batch": _batch})


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to its traced count while a
    profiler records)."""
    _counts[name] = _counts.get(name, 0) + n
    if _recording():
        _traced[name] = _traced.get(name, 0) + n


def counts(traced: bool = False) -> dict:
    """A snapshot of the counters: since the process started, or with
    ``traced`` those made since the profiler that records now (or last
    recorded) started."""
    _recording()
    return dict(_traced if traced else _counts)


@contextlib.contextmanager
def torch_trace(logdir: str):
    """A ``torch.profiler`` trace of the body (host ops, and CUDA kernels
    and copies when CUDA is available), written as a Chrome trace to
    ``logdir/trace.json`` (open it in chrome://tracing or Perfetto). It
    records shapes, so the port's spans carry their batch numbers."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def cuda_frame_ms(fn: Callable[[int], object], frames: int = 7, *,
                  device, warmup: int = 1) -> List[float]:
    """Milliseconds of each of ``frames`` chained calls ``fn(i)``.

    One event is recorded between consecutive calls on the current stream,
    so each interval holds one frame's device work and whatever host launch
    gap the next frame's enqueue leaves. ``warmup`` calls run first."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"cuda_frame_ms times a CUDA device, not {device}")
    with torch.cuda.device(device):
        for i in range(warmup):
            fn(-1 - i)
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(frames + 1)]
        events[0].record()
        for i in range(frames):
            fn(i)
            events[i + 1].record()
        torch.cuda.synchronize(device)
    return [events[i].elapsed_time(events[i + 1]) for i in range(frames)]


# device activities issued in each trace's warm-up step, which the profiler
# discards: on the card it has lost the first records of a trace, more of
# them the longer the process has run (the first 1-12 of 10-15, between 60
# and 170 s), and a window of RayTracer batches holds only a few
WARMUP_ACTIVITIES = 1024


def _device_events(fn: Callable[[int], object], frames: int, device):
    """The CUDA kernel events of a ``torch.profiler`` trace of ``frames``
    chained calls ``fn(i)``, after one warm-up call. The trace opens with a
    warm-up step of :data:`WARMUP_ACTIVITIES` tiny fills, discarded, and
    records the frames in its one active step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the profiler traces CUDA here, not {device}")
    fn(-1)
    pad = torch.empty(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(WARMUP_ACTIVITIES):
            pad.zero_()
        torch.cuda.synchronize(device)
        prof.step()
        for i in range(frames):
            fn(i)
        torch.cuda.synchronize(device)
        prof.step()
    # the active step's range, mirrored on the device, is no device work
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not ev.name.startswith("ProfilerStep")]


def device_ms_by_kernel(fn: Callable[[int], object], frames: int = 5, *,
                        device) -> dict:
    """Device time per frame of each CUDA kernel ``fn`` launches, in ms,
    from a ``torch.profiler`` trace of ``frames`` chained calls (after one
    warm-up call). Empty when the profiler recorded no device activity."""
    out: dict = {}
    for ev in _device_events(fn, frames, device):
        out[ev.name] = out.get(ev.name, 0.0) + ev.device_time_total / 1e3
    return {k: v / frames for k, v in out.items()}


def launch_ms(fn: Callable[[int], object], name: str, launches: int = 10,
              *, device) -> tuple[List[float], List[float]]:
    """Each of ``launches`` calls ``fn(i)`` (one launch of the kernel
    ``name`` each), timed twice in one ``torch.profiler`` window: the
    profiler's duration of the kernel and the CUDA events recorded on the
    stream just before and just after the call, in ms. The calls queue
    behind a spin of about 50 ms, so no launch gap falls inside a pair.

    The events read the card's own timer; the profiler's durations pass
    through its conversion to the host's clock, which has read a whole
    window 1-2% fast or slow on an H100. Returns (profiler, events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"launch_ms times a CUDA device, not {device}")
    with torch.cuda.device(device):
        fn(-1)
        torch.cuda.synchronize(device)
        pairs = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000_000)
            for i in range(launches):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(i)
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize(device)
    traced = [ev.device_time_total / 1e3 for ev in prof.events()
              if ev.device_type == DeviceType.CUDA and name in ev.name]
    return traced, [a.elapsed_time(b) for a, b in pairs]


def device_work(fn: Callable[[int], object], frames: int = 5, *,
                device) -> tuple[float, float]:
    """(device ms, device activities) per frame of ``fn``, summed over
    every kernel and copy it queues, from the same trace as
    :func:`device_ms_by_kernel`."""
    evs = _device_events(fn, frames, device)
    return (sum(ev.device_time_total for ev in evs) / 1e3 / frames,
            len(evs) / frames)


def traced_mrays_per_s(segments: int, ms: float) -> float:
    """Traced ray segments per second, in millions."""
    return segments / (ms * 1e-3) / 1e6
