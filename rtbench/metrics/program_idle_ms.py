"""Device idle ms per traced batch while the host was inside one of the
port's own spans (``tpu_rt_torch.*``: the camera upload, the tables'
order, a kernel wrapper's prepare and launch): the idle gaps of the device
timeline intersected with those spans, from the profiler's trace."""

import bisect

from rtbench.stats import gaps

PREFIX = "tpu_rt_torch."


def read(r):
    tl = r.timeline
    if tl is None or not r.batches_traced:
        return None
    spans = sorted((s, e) for _, op, s, e in tl.ops if op.startswith(PREFIX))
    if not spans:
        return None
    idle = gaps([(s, e) for _, s, e in tl.device], tl.start, tl.end)
    starts = [a for a, _ in idle]
    total = 0.0
    for s, e in spans:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(idle) and idle[i][0] < e:
            total += max(0.0, min(e, idle[i][1]) - max(s, idle[i][0]))
            i += 1
    return 1e-3 * total / r.batches_traced
