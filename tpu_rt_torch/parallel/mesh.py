"""Device mesh + sharded rendering.

Counterpart of ``tpu_rt/parallel/mesh.py``: a 2-D ('tile', 'sample') mesh
splits one frame over devices, in place of the reference's OpenMP fork/join
over a shared image buffer (cpp_raytracer/raytracer_core.cpp:365-384):

  * **tile axis**: image rows are sharded (image-space data parallelism,
    the reference's static pixel partitioning). Each mesh row renders its
    band of rows; the output stays sharded (:class:`ShardedImage`, no
    gather until display).
  * **sample axis**: samples per pixel are sharded. The devices of a mesh
    row render the same band with independent random streams (per-shard
    ``fold_in`` of the mesh coordinates, in place of per-thread PCG32
    seeds) and their sums are reduced in sample-index order.

Rendering is embarrassingly parallel, so the only reduction is the sum
over the sample axis. One process drives every mesh entry it owns, one
after another on each device's current stream; a mesh whose entries
belong to several processes (:mod:`tpu_rt_torch.parallel.multihost`)
exchanges partial bands through the default ``torch.distributed`` process
group, which the caller initializes, and waits at most that group's
timeout on each exchange.

A mesh entry is a :class:`MeshDevice`: a ``torch.device`` with the index
of the process that owns it. Entries may repeat one device: eight entries
of ``torch.device("cpu")`` are a virtual 8-device mesh on the CPU, four of
``cuda:0`` one on a single card. CPU entries run each kernel's plain
version, CUDA entries the kernel itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..core import rng
from ..core import vecmath as vm
from ..core.types import CameraP, SphereScene
from ..ops import cluster as k2
from ..ops import megakernel as k1
from ..render.frame import CP_SHIFT_FOLD, lax_band_sum

AXES = ("tile", "sample")
ENGINES = ("lax", "pallas", "cluster")


@dataclass(frozen=True, eq=False)
class MeshDevice:
    """One mesh entry: a device and the index of the process (the rank in
    the default process group; 0 without one) that renders on it. Entries
    compare by identity, as JAX's devices do, so a mesh may hold many
    entries of one device and still tell them apart."""

    device: torch.device
    process: int = 0


def process_index() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_devices(devices) -> list:
    """Mesh entries for ``devices``: a :class:`MeshDevice` is kept; a
    ``torch.device`` or a device name becomes a new entry of this
    process."""
    me = process_index()
    return [d if isinstance(d, MeshDevice)
            else MeshDevice(torch.device(d), me) for d in devices]


def local_devices() -> list:
    """Every CUDA device of this process as a mesh entry. Raises without a
    CUDA device: a mesh on the CPU is asked for by name (``devices=``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device in this process; pass devices= (for example "
            "[torch.device('cpu')] * 8) for a mesh on the CPU")
    return mesh_devices([torch.device("cuda", i) for i in range(n)])


class Mesh:
    """A ('tile', 'sample') grid of :class:`MeshDevice` entries.

    ``devices`` is the (n_tile, n_sample) object array; ``shape`` maps
    each axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    axis_names = AXES

    def __init__(self, devices):
        rows = [list(mesh_devices(r)) for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty (tile, sample) grid")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for t, r in enumerate(rows):
            for s, d in enumerate(r):
                self.devices[t, s] = d

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def processes(self) -> set:
        return {d.process for d in self.devices.flat}


def make_mesh(n_tile: int | None = None, n_sample: int | None = None,
              devices=None) -> Mesh:
    """Build a ('tile', 'sample') mesh over ``devices`` (default: every
    CUDA device of this process; raises without one).

    The default factorization puts every device on the tile axis (the
    output stays distributed) and one on samples."""
    devices = local_devices() if devices is None else mesh_devices(devices)
    n = len(devices)
    if n_tile is None and n_sample is None:
        n_sample = 1
        n_tile = n
    elif n_tile is None:
        n_tile = n // n_sample
    elif n_sample is None:
        n_sample = n // n_tile
    if n_tile * n_sample != n:
        raise ValueError(f"mesh {n_tile}x{n_sample} != {n} devices")
    return Mesh([devices[t * n_sample:(t + 1) * n_sample]
                 for t in range(n_tile)])


def shard_keys(key: torch.Tensor, n_tile: int, n_sample: int) -> torch.Tensor:
    """Each shard's key, ``fold_in(fold_in(key, ti), si + 1)``: an
    (n_tile, n_sample, 2) tensor on the key's device, the deterministic
    replacement for PCG32(thread_id + 1) (raytracer_core.cpp:377-378),
    independent of which device renders the shard."""
    ti = torch.arange(n_tile, dtype=torch.int64, device=key.device)
    si = torch.arange(n_sample, dtype=torch.int64, device=key.device)
    tile_keys = rng.fold_in(key, ti)                         # (n_tile, 2)
    return rng.fold_in(tile_keys[:, None, :], si[None, :] + 1)


def shard_seed(dev_key: torch.Tensor) -> int:
    """The megakernel's and the cluster engine's int32 seed of a shard:
    its key's second word, wrapped to int32."""
    return k1._signed32(int(dev_key.reshape(-1)[-1]))


class ShardedImage:
    """The (height, width, 3) frame of :func:`render_sharded`, left sharded
    over 'tile'.

    ``bands`` maps each tile index this process owns (the process of the
    tile's first mesh entry) to its (rows, width, 3) band on that entry's
    device; ``shards`` lists the (tile, sample) shards this process
    rendered and ``segments`` their traced ray segments (read from the
    devices when asked). ``gather`` assembles the frame; ``np.asarray``
    gathers to the host."""

    def __init__(self, bands: dict, shape: tuple, mesh: Mesh, shards,
                 shard_segments):
        self.bands = bands
        self.shape = shape
        self.mesh = mesh
        self.shards = tuple(shards)
        self._segments = shard_segments

    @property
    def segments(self) -> int:
        return sum(int(s) for s in self._segments)

    def gather(self, device=None) -> torch.Tensor:
        """The whole frame on ``device`` (default: the device of this
        process's first band, else the CPU). Across processes every band
        is broadcast from its owner through the default process group, so
        every process calls this together and gets the frame."""
        if device is None:
            device = (next(iter(self.bands.values())).device if self.bands
                      else torch.device("cpu"))
        rows = self.shape[0] // self.mesh.devices.shape[0]
        spread = len(self.mesh.processes) > 1
        parts = []
        for ti in range(self.mesh.devices.shape[0]):
            band = self.bands.get(ti)
            if spread:
                band = _broadcast(band, self.mesh.devices[ti, 0].process,
                                  (rows,) + self.shape[1:])
            parts.append(band.to(device))
        return torch.cat(parts)

    def __array__(self, dtype=None, copy=None):
        out = self.gather(torch.device("cpu")).numpy()
        return out if dtype is None else out.astype(dtype)


def _comm_device() -> torch.device:
    """Where a band crosses processes: the host under gloo, this process's
    current CUDA device under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast(band, src: int, shape) -> torch.Tensor:
    """``band`` from process ``src`` to every process of the default
    group (a collective: every process calls it, in the same order)."""
    buf = (band.to(_comm_device()).contiguous() if process_index() == src
           else torch.empty(shape, dtype=torch.float32,
                            device=_comm_device()))
    dist.broadcast(buf, src=src)
    return buf


def _to(nt, device):
    """A NamedTuple of tensors copied to ``device``."""
    return None if nt is None else type(nt)(*(
        f.to(device) if isinstance(f, torch.Tensor) else f for f in nt))


def render_sharded(
    scene: SphereScene,
    cam: CameraP,
    key: torch.Tensor,
    mesh: Mesh,
    width: int = 1920,
    height: int = 1080,
    spp: int = 4,
    max_depth: int = 4,
    mode: str = "v2",
    enable_refraction: bool = False,
    gamma: bool = True,
    engine: str = "lax",
    n_active: int | None = None,
    scene_mesh=None,
    n_tri_active: int | None = None,
    enable_dof: bool = False,
    use_bvh: bool = False,
    nee: bool = False,
    stratify: bool = False,
) -> ShardedImage:
    """Render one frame over the mesh; returns a :class:`ShardedImage` of
    shape (height, width, 3), f32.

    Requires ``height % n_tile == 0`` and ``spp % n_sample == 0``. ``key``
    is a key of :mod:`tpu_rt_torch.core.rng` (``rng.key(seed)``). The
    scene, camera and ``scene_mesh`` (a TriangleMesh) are copied once to
    each device of this process's entries; rows are sharded over 'tile',
    spp over 'sample'; each mesh row's sums are reduced in sample-index
    order on its first entry's device, so every layout of the same mesh
    shape, in one process or several, gives the same bits.

    ``engine`` selects the per-shard renderer: "lax" (general, plain
    torch), "pallas" (the megakernel, at most 64 spheres and 256
    triangles) or "cluster" (large scenes; each band's rows must be a
    multiple of 32). The "pallas" and "cluster" shards render their band
    with the seed :func:`shard_seed` and stratify within the shard; their
    linear means are averaged over 'sample'. The lax shards draw
    ``fold_in(dev_key, s)`` per sample and stratify across the global spp
    (lattice index ``si * spp_per + s``, under a shift keyed by the tile
    alone), so their sums over 'sample' are divided by the global spp.
    ``use_bvh`` and ``mode`` apply to the lax engine. A CPU entry runs the
    plain versions, a CUDA entry the kernels."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
    n_tile, n_sample = mesh.devices.shape
    if height % n_tile != 0:
        raise ValueError(f"height {height} not divisible by tile axis {n_tile}")
    if spp % n_sample != 0:
        raise ValueError(f"spp {spp} not divisible by sample axis {n_sample}")
    if len(mesh.processes) > 1 and not dist.is_initialized():
        raise ValueError(f"the mesh spans processes {sorted(mesh.processes)} "
                         "but no torch.distributed process group is "
                         "initialized")
    rows_per = height // n_tile
    spp_per = spp // n_sample
    me = process_index()
    host_key = key.reshape(2).to("cpu")
    keys = shard_keys(host_key, n_tile, n_sample)
    if engine == "lax" and stratify:
        # the Cranley-Patterson shift of each tile, keyed without the
        # sample index: a mesh row's shards share it
        shifts = rng.fold_in(rng.fold_in(host_key, torch.arange(n_tile)),
                             CP_SHIFT_FOLD)
    local = [(ti, si) for ti in range(n_tile) for si in range(n_sample)
             if mesh.devices[ti, si].process == me]

    replicas = {}

    def replica(device):
        """The scene, camera, mesh and engine tables on ``device``."""
        if device not in replicas:
            r = dict(scene=_to(scene, device), cam=_to(cam, device),
                     mesh=_to(scene_mesh, device), lights=None)
            if engine == "pallas" and nee:
                r["lights"] = k1.light_cdf(r["scene"])
            if engine == "cluster":
                pos = r["cam"].position
                r["tables"] = k2.order_clusters(k2.build_clusters(
                    r["scene"], n_active=n_active), pos)
                r["tri_tables"] = None if scene_mesh is None else (
                    k2.order_clusters(k2.build_tri_clusters(
                        r["mesh"], n_active=n_tri_active), pos))
                if nee:
                    r["lights"] = k2.light_table(r["scene"],
                                                 k2.DEFAULT_LIGHTS)
            replicas[device] = r
        return replicas[device]

    common = dict(width=width, height=height, spp=spp_per,
                  max_depth=max_depth, enable_refraction=enable_refraction,
                  enable_dof=enable_dof, nee=nee, stratify=stratify)
    partial, segments = {}, []
    for ti, si in local:
        device = mesh.devices[ti, si].device
        r = replica(device)
        row0 = ti * rows_per
        if engine == "lax":
            band, segs = lax_band_sum(
                r["scene"], r["cam"], keys[ti, si].to(device), mode=mode,
                mesh=r["mesh"], use_bvh=use_bvh, rows=rows_per,
                row_offset=row0, lattice_offset=si * spp_per,
                shift_key=shifts[ti].to(device) if stratify else None,
                **common)
        elif engine == "pallas":
            band, segs = k1.render_megakernel(
                r["scene"], r["cam"], shard_seed(keys[ti, si]), gamma=False,
                n_active=n_active, rows=rows_per, row_offset=row0,
                mesh=r["mesh"], n_tri_active=n_tri_active,
                lights=r["lights"], with_stats=True, **common)
        else:
            band, segs = k2.render_cluster(
                r["scene"], r["cam"], shard_seed(keys[ti, si]), gamma=False,
                rows=rows_per, row_offset=row0, prebuilt=r["tables"],
                tri_prebuilt=r["tri_tables"], pre_ordered=True,
                lights=r["lights"], with_stats=True, **common)
        partial[ti, si] = band
        segments.append(segs)

    divisor = spp if engine == "lax" else n_sample
    bands = {}
    for ti, band in _sample_sums(mesh, partial, (rows_per, width, 3)).items():
        band = band / torch.tensor(float(divisor), dtype=torch.float32,
                                   device=band.device)
        if gamma:
            band = torch.clamp(vm.sqrt(torch.clamp_min(band, 0.0)), 0.0, 1.0)
        bands[ti] = band
    return ShardedImage(bands, (height, width, 3), mesh, local, segments)


def _sample_sums(mesh: Mesh, partial: dict, shape) -> dict:
    """Each mesh row's partial bands summed in sample-index order on the
    device of the row's first entry, for the rows whose first entry this
    process owns. A partial band of another process than the row's owner
    is broadcast from its process (every process makes the same
    broadcasts in the same order)."""
    me = process_index()
    out = {}
    n_tile, n_sample = mesh.devices.shape
    for ti in range(n_tile):
        owner = mesh.devices[ti, 0]
        acc = None
        for si in range(n_sample):
            src = mesh.devices[ti, si].process
            band = partial.get((ti, si))
            if src != owner.process:
                band = _broadcast(band, src, shape)
            if owner.process != me:
                continue
            band = band.to(owner.device)
            acc = band if acc is None else acc + band
        if acc is not None:
            out[ti] = acc
    return out
