"""Host data the port copied to the device per traced batch: its own
``uploads`` counter over the profiler's window
(``tpu_rt_torch.utils.profiling.counts(traced=True)``) over the traced
batches. None for a program without the counter."""


def read(r):
    if r.timeline is None or not r.batches_traced:
        return None
    from tpu_rt_torch.utils import profiling

    counts = getattr(profiling, "counts", None)
    n = counts(traced=True).get("uploads") if counts is not None else None
    return None if n is None else n / r.batches_traced
