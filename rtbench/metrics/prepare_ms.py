"""Host ms per traced batch inside the port's ``tpu_rt_torch.prepare``
spans (a kernel wrapper's work before its launch: the packed camera, the
attribute or cluster tables' checks, the light table, the output and
scratch allocations): the spans' time directly under the benchmark's
``rtbench.render_device`` over the traced batches, from the profiler's
trace."""

SPAN = "tpu_rt_torch.prepare"


def read(r):
    tl = r.timeline
    if tl is None or not r.batches_traced:
        return None
    times = [e - s for parent, op, s, e in tl.ops
             if parent == "rtbench.render_device" and op == SPAN]
    if not times:
        return None
    return 1e-3 * sum(times) / r.batches_traced
