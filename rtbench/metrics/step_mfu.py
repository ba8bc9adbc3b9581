"""The whole pipeline's share of the card's float32 peak: the least
operations of the traced batches (``rtbench/roofline.py``) over the traced
window's length times the published peak, in percent. It bounds every
kernel's roofline share from below, whichever kernels a batch runs."""

from rtbench.roofline import PEAK_F32_FLOPS


def read(r):
    tl = r.timeline
    if tl is None or not r.batches_traced or tl.window_s <= 0.0:
        return None
    return (100.0 * r.ops_per_batch * r.batches_traced
            / (tl.window_s * PEAK_F32_FLOPS))
