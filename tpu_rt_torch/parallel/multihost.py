"""Multi-host mesh construction: a layout that keeps the sample reduction
inside one host.

Counterpart of ``tpu_rt/parallel/multihost.py``. The ('tile', 'sample')
mesh of :mod:`tpu_rt_torch.parallel.mesh` is built so that **hosts
partition the tile axis**: each host's GPUs own a contiguous block of
image-row bands, and the only reduction (the sum over 'sample') stays
among one host's GPUs, over NVLink or within one GPU. Traffic over the
network between hosts is limited to assembling the frame on whichever
host displays or encodes it: once per displayed frame, never per batch.

A host is one process of the default ``torch.distributed`` process group,
which drives every GPU of its machine (the caller initializes the group,
with its address, world size and rank). Without a group there is one host.
A simulated pod (all entries in one process) passes an explicit
``n_hosts`` to :func:`make_multihost_mesh` and a ``host_of`` mapping to
:func:`sample_groups_are_host_local`.
"""

from __future__ import annotations

from collections import defaultdict

import torch.distributed as dist

from .mesh import Mesh, local_devices, mesh_devices


def group_devices_by_host(devices=None):
    """Mesh entries grouped by owning process (host), in process order.

    ``devices`` are this process's own (default: every CUDA device of this
    process; raises without one). With a process group, every process's
    entries are gathered (``all_gather_object``, a collective: every
    process calls it); without one, this process is the only host."""
    local = local_devices() if devices is None else mesh_devices(devices)
    if dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, local)
        local = [d for part in every for d in part]
    by_host = defaultdict(list)
    for d in local:
        by_host[d.process].append(d)
    return [by_host[p] for p in sorted(by_host)]


def make_multihost_mesh(
    n_hosts: int | None = None,
    devices=None,
    sample_per_host: int = 1,
) -> Mesh:
    """Build a ('tile', 'sample') mesh whose tile axis is host-major.

    Host h's GPUs occupy tile rows ``[h*tiles_per_host, (h+1)*...)`` of
    the mesh, so every 'sample' group (one mesh row) is a subset of a
    single host's GPUs: ``render_sharded``'s sample reduction never
    leaves a host. Traffic between hosts is only the gather of the
    'tile'-sharded output, once per *displayed* frame (or never, if each
    host encodes its own band).

    ``n_hosts=None`` uses the real process topology
    (:func:`group_devices_by_host` of ``devices``); an explicit
    ``n_hosts`` slices ``devices`` (default: every host's entries) into
    equal contiguous blocks, the single-process simulation the tests use.

    ``sample_per_host`` GPUs of each host go to the 'sample' axis
    (intra-host spp parallelism); the rest extend 'tile'.
    """
    if n_hosts is None:
        hosts = group_devices_by_host(devices)
    else:
        devices = ([d for h in group_devices_by_host() for d in h]
                   if devices is None else mesh_devices(devices))
        if len(devices) % n_hosts:
            raise ValueError(
                f"{len(devices)} devices not divisible by {n_hosts} hosts")
        per = len(devices) // n_hosts
        hosts = [devices[h * per:(h + 1) * per] for h in range(n_hosts)]

    per_host = len(hosts[0])
    if any(len(h) != per_host for h in hosts):
        raise ValueError("hosts have unequal device counts")
    if per_host % sample_per_host:
        raise ValueError(
            f"{per_host} GPUs/host not divisible by "
            f"sample_per_host={sample_per_host}")
    tiles_per_host = per_host // sample_per_host

    rows = []
    for h in hosts:
        rows.extend(
            h[t * sample_per_host:(t + 1) * sample_per_host]
            for t in range(tiles_per_host)
        )
    return Mesh(rows)


def sample_groups_are_host_local(mesh: Mesh, host_of=None) -> bool:
    """True iff every 'sample' group lives on ONE host.

    ``host_of``: mesh entry -> host id (defaults to its process index).
    This is the property that keeps the per-batch reduction on NVLink and
    off the network between hosts; the multi-host tests assert it."""
    host_of = (lambda d: d.process) if host_of is None else host_of
    for row in mesh.devices:  # one row = one 'sample' group
        if len({host_of(d) for d in row}) != 1:
            return False
    return True


def dcn_bytes_per_displayed_frame(width: int, height: int,
                                  n_hosts: int) -> int:
    """Bytes crossing the network between hosts to assemble one displayed
    frame on one host.

    The 'tile'-sharded f32 output means each remote host ships only its
    own row band: (n_hosts-1)/n_hosts of the image, once per displayed
    frame. At 1080p over 2 hosts this is ~12 MB a frame: ~360 MB/s at
    30 frames a second.
    """
    frame = width * height * 3 * 4
    return frame * (n_hosts - 1) // n_hosts
