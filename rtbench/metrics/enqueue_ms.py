"""Host ms per batch inside the entry and frame layers
(``RayTracer.render_device`` and ``render.frame.accumulate``): the median
of the benchmark's spans over the batches the profiler did not trace."""

import statistics

MIN_BATCHES = 20


def read(r):
    if len(r.enqueue_s) < MIN_BATCHES:
        return None
    return 1e3 * statistics.median(r.enqueue_s)
