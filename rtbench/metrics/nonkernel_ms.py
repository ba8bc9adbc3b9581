"""Device ms per batch of everything but the path-trace kernels (K1, K2):
the camera and table copies, the accumulation, the display stack and its
pull, from the profiler's trace."""

KERNELS = ("megakernel", "cluster_kernel")


def read(r):
    if r.timeline is None or not r.batches_traced:
        return None
    s = r.timeline.device_s(lambda n: not any(k in n for k in KERNELS))
    return 1e3 * s / r.batches_traced
