"""The port's roofline: the card's measured f32 instruction rate, its
theoretical rate, the path-trace kernels' operation model, and the bounds
built from them.

Counterpart of ``tpu_rt/utils/roofline.py``, designed for the H100:

* :func:`measure_fma_ops` times the FMA microkernel (K3, ``csrc/fma.cu``)
  at two loop depths on one full wave of blocks; the slope (FFMAs over
  time) cancels the launch's fixed cost. One op per FMA instruction.
* :func:`theoretical_fp32_ops` is the card's SMs x 128 FP32 lanes x its
  maximum SM clock, read from the card's own attributes: one f32
  instruction per lane per clock.
* The operation model counts the path-trace kernels' f32 operations from
  the CUDA sources: one for each add, mul, compare, min/max, sqrt, division
  or transcendental. The cluster kernel's walk depends on the data: its
  counting instantiation counts the slab and primitive tests each frame
  did (:func:`cluster_op_model`). The kernels are built with ``--fmad=false``, so no
  FMA is contracted and every counted op is one executed instruction, the
  same unit as the two rates above; so no share of a bound can read over
  100%. The megakernel's NEE shadow sweep stops at its first blocker: its
  counting instantiation counts the tests it ran
  (:func:`megakernel_op_model` with ``visits``).
* :func:`bound_ms` is the least time the card could take for a kernel's
  work: the larger of its f32 operations over an f32 rate and its bytes
  over the memory rate. The bound is taken at the theoretical rate, the
  most the card can issue; at K3's measured rate, which lies below it, it
  is given beside it.
"""

from __future__ import annotations

import ctypes
import statistics
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import build
from ..ops.megakernel import TILE as MEGA_TILE

# One NVIDIA H100 SXM's memory rate (NVIDIA's data sheet, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
#: FP32 lanes of one Hopper SM: four schedulers of 32 lanes each
FP32_LANES_PER_SM = 128

# f32 operations per unit of work of the path-trace kernels, counted from
# the CUDA sources (csrc/path_common.cuh, megakernel.cu, cluster.cu); the
# hash's integer operations are not counted.
SPHERE_TEST_OPS = 24  # oc 3, half_b 5, |oc|^2 - r^2 7, disc 2, sqrt, 2 roots,
                      # 4 compares
SLAB_TEST_OPS = 26    # flag, 6 sub, 6 mul, 6 min/max, enter 3, exit 3, compare
# a slab test of the cluster walk (cluster.cu next_child): the slab test
# and its two compares of the entry (crossed, least so far)
WALK_SLAB_OPS = SLAB_TEST_OPS + 2
TIE_OPS = 1           # a nearest-hit test's t == best t of the (t, key) order
RAY_SETUP_OPS = 12    # the walk's 3 safe reciprocals
SHADE_OPS = 62        # shade_hit without roulette: emission 6, hit point 6,
                      # normal 6, unit ball 18, scatter 23, throughput 3
TRI_TEST_OPS = 53     # Moller-Trumbore (mt_test): pvec 9, det 5, |det| test 2,
                      # 1/det, tvec 3, u 6, qvec 9, v 6, t 6, 6 compares/adds
PRIMARY_OPS = 33      # jitter to a unit camera ray
PIXEL_OPS = 15        # mean, sqrt gamma and clamp of 3 channels
# the optional flags, counted the same way
REFRACT_OPS = 36  # per shaded hit, any material: cos_in 5, front 1, n_e 3,
                  # eta 1, dt 5, disc 5, max + sqrt 2, cosine 1, r0 4, omc 2,
                  # Schlick 5, 2 compares (the glass direction is not counted)
LENS_OPS = 46     # per primary ray: d.fwd 5, max 1, div 1, focal point 6,
                  # sqrt + mul 2, angle 1, cos + sin 2, lx ly 2, origin 12,
                  # direction 3 sub + normalize 11
R2_OPS = 8        # per primary ray: 2 x (mul, add, floor, sub)
NEE_OPS = 120     # per shadow segment (path_common.cuh, kNee): the cosine
                  # sampler's 8 beyond the flipped one, suppression test 11,
                  # pick 1, cone and basis 76, light entry 23, gate 6,
                  # contribution 15 (the shadow sweep itself is counted
                  # apart: K1's sphere and triangle tests up to the first
                  # blocker, megakernel_sweep_ops; K2's in the walk's
                  # counted visits, cluster_walk_ops)

# K3: chains per thread, the multiplier, the threads of a block (fma.cu)
CARRIES = 32
FMA_MUL = float(np.float32(1.0000001))
FMA_BLOCK = 256
# measurement depths for one full wave of blocks on an H100: about 4 and
# 16 ms at 33e12 FFMA/s
FMA_DEPTHS = (16384, 65536)
FMA_WARMUP = 10


# ---------------------------------------------------------------------------
# K3: the FMA chains
# ---------------------------------------------------------------------------

def fma_chains_reference(x: torch.Tensor, depth: int,
                         carries: int = CARRIES) -> torch.Tensor:
    """Plain version of K3: ``carries`` chains per element seeded at
    ``x + f32(0.01 c)``, stepped ``depth`` times as ``v <- v * 1.0000001 +
    x`` rounded once, summed in chain order in f32.

    Each step is computed in float64 and rounded once to f32: the product of
    two f32 values is exact in float64, and for x >= 0 (every chain then
    stays >= x) so is the sum, so the step equals ``fmaf`` and the CUDA
    kernel agrees with this bit for bit."""
    a = x.to(torch.float32)
    a64 = a.double()
    seeds = torch.tensor([float(np.float32(0.01 * c)) for c in range(carries)],
                         dtype=torch.float32, device=a.device)
    v = a.unsqueeze(0) + seeds.reshape((carries,) + (1,) * a.dim())
    for _ in range(int(depth)):
        v = (v.double() * FMA_MUL + a64).float()
    o = v[0]
    for c in range(1, carries):
        o = o + v[c]
    return o


def fma_chains(x: torch.Tensor, depth: int,
               carries: int = CARRIES) -> torch.Tensor:
    """K3 on a contiguous f32 tensor: one thread per element. A CPU tensor
    runs :func:`fma_chains_reference`; a CUDA tensor launches the kernel
    (built on first use, 32 chains only) and raises if the launch fails.
    ``fma_chains.launches`` counts kernel launches."""
    dev = x.device
    if dev.type == "cpu":
        return fma_chains_reference(x, depth, carries)
    if dev.type != "cuda":
        raise ValueError(f"fma_chains runs on cpu or cuda, not {dev}")
    if carries != CARRIES:
        raise ValueError(f"the CUDA kernel carries {CARRIES} chains, "
                         f"not {carries}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fma_chains takes a contiguous float32 tensor")
    if not 0 < x.numel() < 2**31 or depth < 0:
        raise ValueError(f"bad size {x.numel()} or depth {depth}")
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        err = lib.tpurt_fma_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                   int(depth),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma kernel launch failed: CUDA error {err}")
    fma_chains.launches += 1
    return out


fma_chains.launches = 0


class CardFp32(NamedTuple):
    """What the card says of itself: SMs, maximum SM clock (kHz), and how
    many of K3's blocks one SM holds at once."""

    sms: int
    clock_khz: int
    fma_blocks_per_sm: int


def card_fp32(device="cuda") -> CardFp32:
    """The card's attributes (CUDA runtime, through the kernels' library);
    raises off CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"card_fp32 reads a CUDA device, not {dev}")
    lib = build.load()
    vals = [ctypes.c_int(0) for _ in range(3)]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(dev):
        err = lib.tpurt_fma_device(index, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"reading the card's attributes: CUDA error {err}")
    return CardFp32(*(v.value for v in vals))


def theoretical_fp32_ops(device="cuda") -> float:
    """f32 instructions per second the card can execute: SMs x 128 lanes x
    the maximum SM clock (one op per instruction, an FMA included)."""
    c = card_fp32(device)
    return c.sms * FP32_LANES_PER_SM * c.clock_khz * 1e3


def fma_grid(device="cuda") -> int:
    """Threads of one full wave of K3's blocks on the card."""
    c = card_fp32(device)
    return c.sms * c.fma_blocks_per_sm * FMA_BLOCK


class FmaSlope(NamedTuple):
    """A two-depth measurement of K3 (:func:`measure_fma_ops`): the FFMA
    rate and its parts."""

    ops_per_s: float
    n: int
    depths: tuple
    ms: tuple          # median CUDA-event ms of one launch at each depth
    launches: int


def measure_fma_ops(d1: int = FMA_DEPTHS[0], d2: int = FMA_DEPTHS[1],
                    device="cuda", reps: int = 5) -> FmaSlope:
    """The card's measured f32 FFMA instructions per second (one op per
    FMA, ``.ops_per_s``), by the two-depth slope of K3.

    Times K3 at depths ``d1`` < ``d2`` over one full wave of blocks:
    ``FMA_WARMUP`` launches at ``d2`` (the clock ramps up), then ``reps``
    launches of each depth in turns, each between two CUDA events; median.
    The slope counts ``n * 32 * (d2 - d1)`` FFMAs over the difference."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"measure_fma_ops times a CUDA device, not {dev}")
    if not 0 <= d1 < d2 or reps < 1:
        raise ValueError(f"need 0 <= d1 < d2 and reps >= 1, got {d1}, {d2}, "
                         f"{reps}")
    n = fma_grid(dev)
    x = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    before = fma_chains.launches
    with torch.cuda.device(dev):
        for _ in range(FMA_WARMUP):
            fma_chains(x, d2)
        pairs = {d1: [], d2: []}
        for _ in range(reps):
            for d in (d1, d2):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fma_chains(x, d)
                end.record()
                pairs[d].append((start, end))
        torch.cuda.synchronize(dev)
    ms = tuple(statistics.median(a.elapsed_time(b) for a, b in pairs[d])
               for d in (d1, d2))
    dt = max((ms[1] - ms[0]) * 1e-3, 1e-12)
    return FmaSlope(n * CARRIES * (d2 - d1) / dt, n, (d1, d2), ms,
                    fma_chains.launches - before)


# ---------------------------------------------------------------------------
# the path-trace kernels' operations and bounds
# ---------------------------------------------------------------------------

def path_ops(segments: int, n_pix: int, spp: int, per_segment: int,
             flags=None, shadow: int | None = None) -> int:
    """f32 operations every traced segment needs whatever the data, plus the
    full shading of the hits at bounces before the last: with roulette only
    at the last bounce, those are at least segments - rays. ``flags``: the
    render's ``enable_refraction``, ``enable_dof``, ``stratify`` and
    ``nee`` switches. With ``nee``, ``shadow`` is how many of the
    ``segments`` are shadow segments, where a counting kernel counted it;
    ``per_segment`` is then a path segment's."""
    flags = flags or {}
    rays = n_pix * spp
    shade = SHADE_OPS + (REFRACT_OPS if flags.get("enable_refraction") else 0)
    primary = (PRIMARY_OPS + (LENS_OPS if flags.get("enable_dof") else 0)
               + (R2_OPS if flags.get("stratify") else 0))
    if not flags.get("nee"):
        shadow = 0
    elif shadow is None:
        # the count holds one shadow segment per diffuse hit, so at least
        # half of it is bounces; the bound takes the split that costs least
        shadow = segments // 2
    segments -= shadow
    return (segments * per_segment + max(segments - rays, 0) * shade
            + shadow * NEE_OPS + rays * primary + n_pix * PIXEL_OPS)


def megakernel_sweep_ops(visits) -> int:
    """f32 operations of the NEE shadow sweeps of one megakernel frame:
    ``visits`` is ``render_megakernel(..., with_visits=True)``'s
    (n_tiles, 2, 4) counts (or their (2, 4) sum), whose shadow sphere and
    triangle tests (each sweep up to its first blocker) count
    :data:`SPHERE_TEST_OPS` and :data:`TRI_TEST_OPS` each."""
    v = torch.as_tensor(visits).reshape(-1, 2, 4).sum(dim=0).tolist()
    return int(v[1][1] * SPHERE_TEST_OPS + v[1][2] * TRI_TEST_OPS)


def megakernel_op_model(segments: int, n_pix: int, spp: int, n_spheres: int,
                        *, n_tris: int = 0, flags=None, visits=None) -> int:
    """f32 operations of one megakernel (K1) frame that sweeps ``n_spheres``
    rows and ``n_tris`` triangles per path segment, from the kernel's own
    count of traced ``segments``.

    With NEE, ``visits`` (``render_megakernel(..., with_visits=True)``'s
    (n_tiles, 2, 4) counts) gives the counted split of the segments and
    the shadow rays' sphere and triangle tests
    (:func:`megakernel_sweep_ops`); without it the model takes half of the
    segments as shadow segments and no shadow sweep, the least a NEE frame
    could cost. With ``visits`` the model counts every segment the grid
    traced, lanes past the last pixel included; ``segments`` must be the
    same frame's count, as the visits hold it or as ``with_stats`` reports
    it over ``n_pix`` real pixels (scaled by n_pix / (n_tiles * 4096)).

    It differs from the JAX package's model, which counts every lane at
    every bounce: the TPU kernel is masked-dense, so a dead lane still
    executes. On the card K1 runs one thread per (pixel, sample) and a path
    that dies leaves its bounce loop, so the work is what the traced
    segments need; a dense count would overstate it by the share of dead
    paths."""
    per_segment = n_spheres * SPHERE_TEST_OPS + n_tris * TRI_TEST_OPS
    if visits is None:
        return path_ops(segments, n_pix, spp, per_segment, flags)
    tiles = torch.as_tensor(visits).reshape(-1, 2, 4)
    v = tiles.sum(dim=0).tolist()
    traced = v[0][0] + v[1][0]
    real = int(np.float32(traced)
               * np.float32(n_pix / (tiles.shape[0] * MEGA_TILE)))
    if segments not in (traced, real):
        raise ValueError(f"the visits count {v[0][0]} + {v[1][0]} segments "
                         f"({real} over the real pixels), not {segments}")
    return (path_ops(traced, n_pix, spp, per_segment, flags, v[1][0])
            + megakernel_sweep_ops(visits))


def cluster_walk_ops(visits) -> int:
    """f32 operations of the cluster walk's counted visits: ``visits`` is
    ``render_cluster(..., with_visits=True)``'s (n_tiles, 2, 7) counts (or
    their (2, 7) sum): for path and shadow rays the slab tests of the four
    levels at :data:`WALK_SLAB_OPS` each, and the sphere and triangle tests
    (globals included) at :data:`SPHERE_TEST_OPS` and :data:`TRI_TEST_OPS`,
    with the tie compare on path rays (nearest-hit); shadow rays are
    any-hit. The warps' column is not an operation count."""
    v = torch.as_tensor(visits).reshape(-1, 2, 7).sum(dim=0).tolist()
    ops = 0
    for kind, row in enumerate(v):
        tie = TIE_OPS if kind == 0 else 0
        ops += (sum(row[0:4]) * WALK_SLAB_OPS
                + row[4] * (SPHERE_TEST_OPS + tie)
                + row[5] * (TRI_TEST_OPS + tie))
    return int(ops)


def cluster_op_model(segments: int, visits, n_pix: int, spp: int,
                     flags=None) -> int:
    """f32 operations of one cluster-kernel (K2) frame: the segments' ray
    setup (the walk's 3 reciprocals), shading, primary rays, NEE and pixels
    (:func:`path_ops`), plus the walk the kernel did, counted by its
    counting instantiation (:func:`cluster_walk_ops`). The work depends on
    the data, so it is what this frame's rays needed, not the most they
    could; the same unit as :func:`megakernel_op_model`."""
    return (path_ops(segments, n_pix, spp, RAY_SETUP_OPS, flags)
            + cluster_walk_ops(visits))


def cluster_floor_per_segment(n_global: int, n_ss: int,
                              n_tri_global: int = 0, n_tri_ss: int = 0
                              ) -> int:
    """f32 operations every K2 path segment needs whatever the walk's
    design: the ray setup, every global of both tables and the slab test of
    every super-super (each walk starts at the top level). With
    :func:`path_ops` it gives a floor under :func:`cluster_op_model` that a
    walk which visits more does not raise."""
    return (RAY_SETUP_OPS + n_global * SPHERE_TEST_OPS
            + n_tri_global * TRI_TEST_OPS + (n_ss + n_tri_ss) * SLAB_TEST_OPS)


def megakernel_bytes(n_spheres: int, n_pix: int, n_tris: int = 0) -> int:
    """Bytes one K1 frame must move: the attribute table, camera and
    background read once, the triangle table (21 f32 a row), the (n_pix, 3)
    f32 image and one int32 count per 4096-pixel tile written once."""
    return ((n_spheres * 16 + 16 + 3) * 4 + n_tris * 21 * 4 + n_pix * 12
            + -(-n_pix // 4096) * 4)


def bound_ms(ops: float, nbytes: float,
             ops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it) for ``ops`` f32 operations at
    ``ops_per_s`` and ``nbytes`` bytes at the memory rate."""
    t_ops = ops / ops_per_s * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_report(frame_s: float, width: int, height: int, spp: int,
                    depth: int, n_spheres: int, *, segments: int,
                    n_tris: int = 0, flags=None, fma_ops: float | None = None,
                    theoretical_ops: float | None = None,
                    device="cuda") -> dict:
    """A bench's roofline payload for one megakernel frame of
    ``frame_s`` seconds (the chained, steady-state frame time) that traced
    ``segments`` segments at ``width`` x ``height``, ``spp`` samples and
    ``depth`` bounces over ``n_spheres`` swept rows (and ``n_tris``
    triangles). The FMA and theoretical rates are measured on ``device``
    unless given (``fma_ops``, ``theoretical_ops``). ``bound_ms`` is the
    least frame time at the theoretical rate, ``bound_ms_measured`` at the
    measured one."""
    nee = bool((flags or {}).get("nee"))
    n_pix = width * height
    if not 0 <= segments <= n_pix * spp * depth * (2 if nee else 1):
        raise ValueError(f"{segments} segments cannot come from "
                         f"{n_pix} pixels x {spp} spp x depth {depth}")
    fma = (measure_fma_ops(device=device).ops_per_s if fma_ops is None
           else fma_ops)
    peak = (theoretical_fp32_ops(device) if theoretical_ops is None
            else theoretical_ops)
    ops = megakernel_op_model(segments, n_pix, spp, n_spheres, n_tris=n_tris,
                              flags=flags)
    nbytes = megakernel_bytes(n_spheres, n_pix, n_tris)
    achieved = ops / frame_s
    b_ms, b_by = bound_ms(ops, nbytes, peak)
    return {
        "model_vector_ops_per_frame_g": ops / 1e9,
        "achieved_gops": achieved / 1e9,
        "fp32_theoretical_gops": peak / 1e9,
        "fma_slope_measured_gops": fma / 1e9,
        "utilization_vs_theoretical_pct": 100.0 * achieved / peak,
        "achieved_over_fma_bracket": achieved / fma,
        "arithmetic_intensity_ops_per_hbm_byte": ops / nbytes,
        "bound": ("compute (f32 instructions)" if b_by == "operations"
                  else "memory (HBM)"),
        "bound_ms": b_ms,
        "bound_ms_measured": bound_ms(ops, nbytes, fma)[0],
        "note": ("op model counted from the CUDA sources per traced segment "
                 "(the kernel's own count): one op per f32 instruction, no "
                 "FMA contracted (--fmad=false), the hash's integer "
                 "operations not counted, so it is a lower bound on the "
                 "work; theoretical = SMs x 128 FP32 lanes x the maximum SM "
                 "clock, from the card's attributes, the rate the bound "
                 "divides by; the FMA slope is K3's measured FFMA rate"),
    }
