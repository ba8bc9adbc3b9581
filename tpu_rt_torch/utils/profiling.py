"""Frame timing on the card and traced-ray throughput.

Counterpart of ``tpu_rt/utils/profiling.py``: CUDA events stand in for
``block_until_ready`` fences. Timing is a device measurement, so it raises
on anything but a CUDA device instead of timing a CPU run.
"""

from __future__ import annotations

from typing import Callable, List

import torch


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


def _device_events(fn: Callable[[int], object], frames: int, device):
    """The CUDA kernel events of a ``torch.profiler`` trace of ``frames``
    chained calls ``fn(i)``, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the profiler traces CUDA here, not {device}")
    fn(-1)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            fn(i)
        torch.cuda.synchronize(device)
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def device_ms_by_kernel(fn: Callable[[int], object], frames: int = 5, *,
                        device) -> dict:
    """Device time per frame of each CUDA kernel ``fn`` launches, in ms,
    from a ``torch.profiler`` trace of ``frames`` chained calls (after one
    warm-up call). Empty when the profiler recorded no device activity."""
    out: dict = {}
    for ev in _device_events(fn, frames, device):
        out[ev.name] = out.get(ev.name, 0.0) + ev.device_time_total / 1e3
    return {k: v / frames for k, v in out.items()}


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
