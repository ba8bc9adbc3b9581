"""Device ms per batch of K1, the megakernel (``csrc/megakernel.cu``), one
launch a batch, from the profiler's trace."""

K1 = "megakernel"


def read(r):
    tl = r.timeline
    if tl is None or not r.batches_traced or not tl.count(lambda n: K1 in n):
        return None
    return 1e3 * tl.device_s(lambda n: K1 in n) / r.batches_traced
