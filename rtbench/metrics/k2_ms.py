"""Device ms per batch of K2, the cluster engine (``csrc/cluster.cu``):
its launches, one per chunk of samples, with their mean passes, from the
profiler's trace."""

K2 = "cluster_kernel"


def read(r):
    tl = r.timeline
    if tl is None or not r.batches_traced or not tl.count(lambda n: K2 in n):
        return None
    return 1e3 * tl.device_s(lambda n: K2 in n) / r.batches_traced
