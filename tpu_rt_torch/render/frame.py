"""Frame rendering: engine choice, batch render, tone map, accumulation.

Counterpart of ``tpu_rt/render/frame.py``, with its three engines: the
megakernel, engine "pallas" as in the JAX package (at most 64 spheres,
beside at most 256 triangles), the cluster engine (larger sphere scenes or
meshes), and the lax engine (``ops/integrator.py``: the v1 estimator,
linear output under ``engine="auto"``, the LBVH). ``select_engine``
resolves as the JAX package does on a TPU.

Outputs match the reference contract: a batch is the sample mean,
sqrt-gamma'd and clamped to [0, 1] (or, with ``gamma=False``, the linear
mean). Adaptive sampling renders with a per-tile mask and merges with
:func:`accumulate_tiled` (megakernel tiles) or
:func:`accumulate_tiled_mapped` over :func:`cluster_tile_map` (cluster
screen blocks).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cammod
from ..core import rng
from ..core import vecmath as vm
from ..core.types import CameraP, SphereScene
from ..ops.cluster import ClusteredScene, render_cluster
from ..ops.cluster import LANES, SUBLANES
from ..ops.integrator import trace
from ..ops.megakernel import MAX_SPHERES, MAX_TRIS, TILE, render_megakernel
from ..utils import profiling

ENGINES = ("auto", "pallas", "lax", "cluster")


# R2 lattice steps of stratified sampling
R2_ALPHA = (0.7548776662466927, 0.5698402909980532)
# the fold-in datum of the lax engine's Cranley-Patterson shift
CP_SHIFT_FOLD = 0x7FFFABCD
# rays x primitives one lax trace call sweeps at most (samples are stacked
# into one call up to it)
LAX_PAIRS_PER_CALL = 1 << 26


def select_engine(scene: SphereScene, mode="v2", enable_refraction=False,
                  gamma=True, mesh=None, engine="auto") -> str:
    """Resolve the engine ``render`` uses, as the JAX package does on a
    TPU: "pallas" (the megakernel) for v2 with gamma within its buckets (64
    spheres, 256 triangles), "cluster" for v2 with gamma past them, "lax"
    otherwise (the v1 estimator, linear output); a named engine is
    returned as asked. Every engine carries refraction, so
    ``enable_refraction`` (kept for the JAX package's signature) does not
    change the choice. An engine name the JAX package does not know raises
    ValueError."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine != "auto":
        return engine
    if mode == "v2" and gamma:
        big = scene.capacity > MAX_SPHERES or (
            mesh is not None and mesh.capacity > MAX_TRIS)
        return "cluster" if big else "pallas"
    return "lax"


def quantize_count(n: int, capacity: int) -> int:
    """Quantize an active-primitive count to a multiple of 4 (65-256: 16;
    above: 512), capped at the bucket, as the JAX package's static kernel
    parameter does, so both sweep the same rows."""
    if not n:
        return 1
    n = int(n)
    if n > 256:
        return min(capacity, -512 * (-n // 512))
    if n > 64:
        return min(capacity, -16 * (-n // 16))
    return min(capacity, -4 * (-n // 4))


def render(
    scene: SphereScene,
    cam: CameraP,
    seed: int,
    width: int = 640,
    height: int = 480,
    spp: int = 8,
    max_depth: int = 4,
    mode: str = "v2",
    enable_refraction: bool = False,
    gamma: bool = True,
    jitter: bool = True,
    with_stats: bool = False,
    mesh=None,
    engine: str = "auto",
    n_active: int | None = None,
    enable_dof: bool | None = None,
    nee: bool = False,
    stratify: bool = False,
    tile_mask=None,
    prebuilt: ClusteredScene | None = None,
    pre_ordered: bool = False,
    n_tri_active: int | None = None,
    tri_prebuilt: ClusteredScene | None = None,
    lights: torch.Tensor | None = None,
    use_bvh: bool = False,
    diffuse_sampling: str = "ball",
    tables=None,
    packed_camera: torch.Tensor | None = None,
):
    """Render one batch of ``spp`` samples; returns (height, width, 3) f32
    on the scene's device (plus the traced segment count with
    ``with_stats``). ``mesh`` adds a TriangleMesh on the same device (the
    nearer surface wins per bounce). ``enable_refraction`` makes materials
    with metallic <= 0, roughness <= 0 and ior > 1 glass; ``enable_dof``
    traces the camera's thin lens (None: when ``cam.aperture`` > 0);
    ``stratify`` puts each pixel's samples on the R2 lattice; ``nee`` adds
    next-event estimation towards the emissive spheres (``lights``: the
    engine's light cdf or table, ``ops/megakernel.py:light_cdf`` or
    ``ops/cluster.py:light_table``, built per call when None).
    ``gamma=False`` returns the linear mean (under ``engine="auto"``, from
    the lax engine, as in the JAX package).
    ``tile_mask`` (adaptive sampling): one int32 per tile of the engine
    that resolves (the megakernel's 4096-pixel runs, the cluster engine's
    32x128 screen blocks, :func:`cluster_tile_map`); a tile with 0 is
    skipped and returns zeros (and no segments). The lax engine takes no
    mask (ValueError).
    ``use_bvh`` makes the lax engine intersect through the LBVH of both
    geometries; ``diffuse_sampling="cosine"`` gives it the exact cosine
    sampler (NEE forces it). The other engines ignore both.

    ``seed`` is the int stream seed (the JAX package derives it from a key
    or takes it from ``seed=``); the lax engine draws from the threefry key
    ``rng.key(seed)``, as the JAX RayTracer's ``jax.random.key(seed)``.
    ``jitter=False`` shoots pixel centres, the deterministic mode of the
    golden-image tests.
    ``n_active``/``n_tri_active``: the quantized active sphere and triangle
    counts (:func:`quantize_count`); None pulls ``valid`` to the host once.
    ``prebuilt``/``tri_prebuilt``/``pre_ordered`` pass the cluster engine
    tables built once per scene (and mesh) and ordered once per camera
    position (``ops/cluster.py``); without them the cluster engine builds
    and orders its tables in every call.
    ``tables``/``packed_camera`` pass the kernel's inputs built once per
    scene (or camera position) and per pose, for the engine that resolves
    (``ops/megakernel.py:scene_tables`` or ``ops/cluster.py:check_tables``,
    and ``ops/megakernel.py:pack_camera``); without them the kernel's
    wrapper builds them in every call. The lax engine reads neither.
    """
    resolved = select_engine(scene, mode, enable_refraction, gamma, mesh,
                             engine)
    if tile_mask is not None and resolved == "lax":
        raise ValueError(
            "tile_mask (adaptive sampling) is a megakernel and cluster "
            "engine capability (megakernel: linear 4096-pixel tiles; "
            "cluster: 32x128 screen blocks); this configuration resolves "
            f"to engine={resolved!r}")
    if enable_dof is None:
        # pulls one scalar from a camera on the device; RayTracer passes
        # the flag from its host-side aperture instead
        enable_dof = float(cam.aperture) > 0.0
    if resolved == "lax":
        return _render_lax(
            scene, cam, rng.key(seed, device=scene.device), width=width,
            height=height, spp=spp, max_depth=max_depth, mode=mode,
            enable_refraction=enable_refraction, gamma=gamma, jitter=jitter,
            with_stats=with_stats, mesh=mesh, use_bvh=use_bvh,
            enable_dof=enable_dof, nee=nee,
            diffuse_sampling=diffuse_sampling, stratify=stratify)
    flags = dict(enable_refraction=enable_refraction, enable_dof=enable_dof,
                 stratify=stratify, nee=nee, gamma=gamma, lights=lights,
                 tile_mask=tile_mask, tables=tables,
                 packed_camera=packed_camera)
    if n_active is None and prebuilt is None:
        n_active = quantize_count(int(scene.valid.sum()), scene.capacity)
    if tri_prebuilt is not None and resolved != "cluster":
        raise ValueError("tri_prebuilt holds cluster-engine tables, but this "
                         f"call resolves to the {resolved}")
    if mesh is not None and n_tri_active is None and tri_prebuilt is None:
        n_tri_active = quantize_count(int(mesh.valid.sum()), mesh.capacity)
    if resolved == "cluster":
        return render_cluster(
            scene, cam, seed, width=width, height=height, spp=spp,
            max_depth=max_depth, jitter=jitter, with_stats=with_stats,
            n_active=n_active, prebuilt=prebuilt, pre_ordered=pre_ordered,
            mesh=mesh, n_tri_active=n_tri_active, tri_prebuilt=tri_prebuilt,
            **flags)
    return render_megakernel(
        scene, cam, seed, width=width, height=height, spp=spp,
        max_depth=max_depth, jitter=jitter, n_active=n_active,
        with_stats=with_stats, mesh=mesh, n_tri_active=n_tri_active, **flags)


def _render_lax(scene, cam, key, *, width, height, spp, max_depth, mode,
                enable_refraction, gamma, jitter, with_stats, mesh,
                use_bvh=False, enable_dof=False, nee=False,
                diffuse_sampling="ball", stratify=False):
    """The lax engine's batch: :func:`lax_band_sum` over the whole frame,
    the mean sqrt-gamma'd and clamped unless ``gamma=False``."""
    acc, segments = lax_band_sum(
        scene, cam, key, width=width, height=height, spp=spp,
        max_depth=max_depth, mode=mode, enable_refraction=enable_refraction,
        jitter=jitter, mesh=mesh, use_bvh=use_bvh, enable_dof=enable_dof,
        nee=nee, diffuse_sampling=diffuse_sampling, stratify=stratify)
    profiling.count("uploads")
    img = acc / torch.tensor(float(spp), dtype=torch.float32,
                             device=scene.device)
    if gamma:
        img = torch.clamp(vm.sqrt(torch.clamp_min(img, 0.0)), 0.0, 1.0)
    if with_stats:
        return img, segments
    return img


def lax_band_sum(scene, cam, key, *, width, height, spp, max_depth,
                 mode="v2", enable_refraction=False, jitter=True, mesh=None,
                 use_bvh=False, enable_dof=False, nee=False,
                 diffuse_sampling="ball", stratify=False, rows=None,
                 row_offset=0, shift_key=None, lattice_offset=0):
    """The lax engine's sum of ``spp`` samples over the band of ``rows``
    rows from frame row ``row_offset`` (the whole frame by default): sample
    s draws from ``fold_in(key, s)``, split into its jitter key and its
    trace key (the lens from ``fold_in(k_s, 7)``; with ``stratify`` the R2
    lattice point ``lattice_offset + s`` under a per-pixel shift drawn from
    ``shift_key``, by default ``fold_in(key, 0x7FFFABCD)``), the samples'
    colours summed in order from zero. Samples are traced together, each
    with its own key, up to ``LAX_PAIRS_PER_CALL`` ray-primitive pairs a
    call. Returns the (rows, width, 3) sum and the traced segments."""
    dev = scene.device
    rows = height if rows is None else rows
    R = rows * width
    if jitter and stratify:
        if shift_key is None:
            shift_key = rng.fold_in(key, CP_SHIFT_FOLD)
        cp_shift = rng.uniform(shift_key, (rows, width, 2))
        profiling.count("uploads")
        r2_alpha = torch.tensor(R2_ALPHA, dtype=torch.float32, device=dev)
    prims = 1 if use_bvh else scene.capacity + (
        mesh.capacity if mesh is not None else 0)
    per_call = max(1, min(spp, LAX_PAIRS_PER_CALL // (R * prims)))
    acc = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    for s0 in range(0, spp, per_call):
        s_idx = torch.arange(s0, min(spp, s0 + per_call), dtype=torch.int64,
                             device=dev)
        S = s_idx.shape[0]
        k_s = rng.fold_in(key, s_idx)                        # (S, 2)
        k_jit, k_trace = rng.split(k_s, 2).unbind(-2)
        if jitter and stratify:
            s_g = (s_idx + lattice_offset).to(torch.float32)
            xi = cp_shift + s_g[:, None, None, None] * r2_alpha
            xi = xi - torch.floor(xi)
        elif jitter:
            xi = rng.uniform(k_jit, (rows, width, 2))        # (S, rows, W, 2)
        else:
            xi = None
        u, v = cammod.pixel_uv(width, height, xi, device=dev, rows=rows,
                               row_offset=row_offset)
        u = torch.broadcast_to(u, (S, rows, width)).reshape(S * R)
        v = torch.broadcast_to(v, (S, rows, width)).reshape(S * R)
        lens = (rng.uniform(rng.fold_in(k_s, 7), (R, 2)).reshape(S * R, 2)
                if enable_dof else None)
        o, d = cammod.generate_rays(cam, u, v, lens_xi=lens)
        color, nseg = trace(
            scene, o, d, k_trace, max_depth=max_depth, mode=mode,
            enable_refraction=enable_refraction, with_stats=True, mesh=mesh,
            use_bvh=use_bvh, nee=nee, diffuse_sampling=diffuse_sampling)
        for c in color.reshape(S, R, 3):  # in sample order, as a scan
            acc = acc + c
        segments = segments + nseg
    return acc.reshape(rows, width, 3), segments


def tone_map(image: torch.Tensor, exposure: float) -> torch.Tensor:
    """Reinhard tone map x*e / (1 + x*e), clamped."""
    image = image * exposure
    image = image / (1.0 + image)
    return torch.clamp(image, 0.0, 1.0)


def _percentiles(values: torch.Tensor, qs) -> list:
    """Linearly interpolated quantiles ``qs`` of a 1-D f32 tensor, of any
    size, in ``jnp.percentile``'s arithmetic: the position q * (n - 1) in
    f32, the sorted values at its floor and ceiling, weighted by its
    fraction. (``torch.quantile`` refuses more than 2^24 elements.)"""
    ordered = torch.sort(values).values
    n = values.numel()
    out = []
    for q in qs:
        pos = np.float32(q) * np.float32(n - 1)
        low, high = np.floor(pos), np.ceil(pos)
        w_high = pos - low
        w_low = np.float32(1.0) - w_high
        out.append(ordered[min(int(low), n - 1)] * float(w_low)
                   + ordered[min(int(high), n - 1)] * float(w_high))
    return out


def enhance_contrast(image: torch.Tensor) -> torch.Tensor:
    """Percentile 2-98 contrast stretch, with the percentiles of
    ``jnp.percentile`` (linear interpolation), at any image size."""
    lo, hi = _percentiles(image.reshape(-1), (0.02, 0.98))
    stretched = torch.clamp((image - lo) / torch.clamp_min(hi - lo, 1e-12),
                            0.0, 1.0)
    return torch.where(hi > lo, stretched, image)


def accumulate(accumulated: torch.Tensor | None, total_samples: int,
               batch: torch.Tensor, batch_samples: int):
    """Progressive weighted merge old*w0 + new*w1.

    Exactly the reference's accumulation, including its averaging of
    post-gamma batches. Returns (accumulator, total samples)."""
    if accumulated is None or total_samples == 0:
        return batch, batch_samples
    total_new = total_samples + batch_samples
    return (accumulated * (total_samples / total_new)
            + batch * (batch_samples / total_new)), total_new


# ---- adaptive tile sampling ------------------------------------------------
# The progressive loop can stop sampling tiles whose accumulated image has
# converged (render(tile_mask=...) skips them). These helpers keep the
# per-tile bookkeeping on the device: a weighted merge with per-tile sample
# counts, and the per-tile change the controller thresholds on
# (tpu_rt/render/frame.py:452-526, in the same order of operations).

def _pixel_weights(tile_vals: torch.Tensor, n_pix: int, shape2) -> torch.Tensor:
    """(n_tiles,) per-tile values -> (h, w, 1) per-pixel plane (the
    megakernel's tiles are runs of TILE pixels in scan order)."""
    per_pix = tile_vals.repeat_interleave(TILE)[:n_pix]
    return per_pix.reshape(shape2[0], shape2[1], 1)


def _tiled_weights(counts, tile_mask, n_new):
    """(on, counts', per-tile weight of the new batch)."""
    on = tile_mask.to(torch.float32)
    new_counts = counts + on * n_new
    w_new = torch.where(new_counts > 0,
                        n_new / torch.clamp_min(new_counts, 1.0), 0.0) * on
    return on, new_counts, w_new


def accumulate_tiled(acc: torch.Tensor, counts: torch.Tensor,
                     batch: torch.Tensor, tile_mask: torch.Tensor,
                     n_new: int, tile_px: int):
    """Per-tile progressive merge: active tiles blend ``batch`` in by their
    sample counts, masked tiles keep their accumulated value.

    acc: (h, w, 3); counts: (n_tiles,) f32 samples accumulated per tile;
    batch: (h, w, 3) from a render with ``tile_mask`` (zeros in masked
    tiles); tile_mask: (n_tiles,) int32. Returns (acc', counts',
    tile_change): the mean |batch - acc| per active tile, averaged over
    ``tile_px`` pixels per tile, the last tile's padding included (as the
    JAX package averages it)."""
    h, w, _ = acc.shape
    n_pix = h * w
    on, new_counts, w_new = _tiled_weights(counts, tile_mask, n_new)
    acc_new = acc + (batch - acc) * _pixel_weights(w_new, n_pix, (h, w))
    diff = (batch - acc).abs().mean(dim=-1).reshape(-1)
    pad = counts.shape[0] * tile_px - n_pix
    diff = torch.cat([diff, diff.new_zeros((pad,))])
    tile_change = diff.reshape(counts.shape[0], tile_px).mean(dim=-1)
    return acc_new, new_counts, tile_change * on


def cluster_tile_map(width: int, height: int, *, device="cuda"):
    """Pixel -> tile map of the cluster engine's adaptive masks: its tiles
    are 32x128-pixel screen blocks, row-major over ceil(h/32) x
    ceil(w/128). Returns ((h, w) int32 map on ``device``, n_tiles); pair
    with :func:`accumulate_tiled_mapped`."""
    bx = -(-width // LANES)
    by = -(-height // SUBLANES)
    ys = torch.arange(height, dtype=torch.int32, device=device) // SUBLANES
    xs = torch.arange(width, dtype=torch.int32, device=device) // LANES
    return ys[:, None] * bx + xs[None, :], bx * by


def accumulate_tiled_mapped(acc: torch.Tensor, counts: torch.Tensor,
                            batch: torch.Tensor, tile_mask: torch.Tensor,
                            n_new: int, tile_map: torch.Tensor, n_tiles: int):
    """:func:`accumulate_tiled` for any pixel -> tile map (the cluster
    engine's, :func:`cluster_tile_map`). Same contract; tile_change is the
    mean |batch - acc| over each active tile's pixels."""
    on, new_counts, w_new = _tiled_weights(counts, tile_mask, n_new)
    acc_new = acc + (batch - acc) * w_new[tile_map.long()][..., None]
    diff = (batch - acc).abs().mean(dim=-1).reshape(-1)
    flat_map = tile_map.reshape(-1).long()
    sums = diff.new_zeros((n_tiles,)).index_add_(0, flat_map, diff)
    cnts = diff.new_zeros((n_tiles,)).index_add_(
        0, flat_map, torch.ones_like(diff))
    tile_change = sums / torch.clamp_min(cnts, 1.0)
    return acc_new, new_counts, tile_change * on
