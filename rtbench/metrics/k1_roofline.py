"""K1's share of its roofline: the least time a batch's work needs at the
published peaks (``rtbench/roofline.py``) over K1's device time per batch,
in percent."""

from rtbench.roofline import bound_s

K1 = "megakernel"


def read(r):
    tl = r.timeline
    if tl is None or not r.batches_traced or not tl.count(lambda n: K1 in n):
        return None
    per_batch = tl.device_s(lambda n: K1 in n) / r.batches_traced
    return 100.0 * bound_s(r.ops_per_batch, r.bytes_per_batch)[0] / per_batch
