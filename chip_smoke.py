"""Run the PyTorch/CUDA port's render paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from tpu_rt_torch/csrc and checks the FMA
microkernel (K3) against its plain version bit for bit; measures the card's
f32 instruction rate with it (the two-depth slope, which must lie within
0.5 and 1.05 of SMs x 128 lanes x the maximum SM clock). Every bound below
divides f32 operations by that theoretical rate, the most the card can
issue, and prints the bound at the measured rate beside it; the script
fails if a kernel runs faster than its bound. Then for each engine it
checks the kernel against golden images and against its plain PyTorch
version, drives its main path through the user's entry points with launch
counts, checks the 1/sqrt(N) convergence of its means, and times it:

* the megakernel (at most 64 spheres): the demo scene through
  RayTracer.render_device -> accumulate -> display_stack at 640x480/8spp/d4;
* the cluster engine (larger sphere scenes): random_spheres(10000, seed=1,
  spread=30) through the same chain, entered as Scene/Sphere objects, and
  timed at 1080p/4spp/d4, at 640x480/8spp/d4 and at 100k spheres;
* triangle meshes: the Cornell box (12 triangles) through the megakernel
  and terrain_mesh(n=72) (10,082 triangles) through the cluster engine,
  each through RayTracer.set_mesh and the same chain, an OBJ file through
  the headless app's --obj, and timings of the Cornell box, of 10k and
  100k terrain triangles and of the terrain's main path;
* refraction, the thin lens (DOF) and R2 stratified sampling in both
  kernels: the demo scene, a glass Cornell box, a 10k-sphere glass field and
  the 10k terrain; RayTracer(enable_refraction=True) with an aperture and
  set_stratify(True) on the demo scene and on the glass field, the headless
  app's --aperture, the display at 4K UHD, and timings;
* next-event estimation (NEE) and linear output in both kernels: the demo
  scene, the Cornell box with a bulb, the blocker scene of tests/test_nee.py,
  the glass field, the terrain and a scene of 12 lights (past the cluster
  engine's cap of 8), alone, with the flags and linear; RayTracer(nee=True)
  on the demo scene and on 10k spheres and set_nee(True) on the Cornell box;
  K1 and K2 means against each other in linear output, NEE's variance
  against the plain estimator's, and timings at 640x480/8spp and 1080p/4spp;
* adaptive tile masks and bands of rows in both kernels: masked and banded
  kernels against their plain versions in every instantiation, masked
  kernels against unmasked ones at full size, K2 bands stitched against the
  full frame; the adaptive main paths (RayTracer.render_device(tile_mask=)
  -> accumulate_tiled -> the app's per-tile controller -> display_stack on
  the demo scene, and render(tile_mask=) -> accumulate_tiled_mapped on 10k
  spheres) against their plain chains, and timings at 100%, about 50% and
  about 10% of the tiles active.
* the display path: the demo scene through RayTracer.render_device ->
  accumulate -> display_stack with the four denoisers (bilateral, nlmeans,
  gaussian, median) at grid_scale 2 (-> unpack_grid) and 1, held against
  the same stack on the CPU, and the first-hit AOVs (render_aovs) of the
  demo scene and the Cornell box with the joint denoiser, held against the
  CPU; device times of each.
* the cluster kernel's walk: vecmath.sqrt on the card against numpy's IEEE
  square root, the tie scene (core/scenes.py:tie_scene, equal hits in two
  clusters) kernel against plain, the counting instantiation's visit
  counts against walk_visits_reference in every instantiation and at 100k
  spheres, a frame's samples in chunks against one chunk and the plain
  version, and the counting kernel against the timed one at the 100k-sphere
  NEE shapes where a counting build with counters in registers faulted.
* the megakernel's lanes per (pixel, sample): every instantiation at spp
  1, 3, 8, 13, 33 and 40, whole, masked and in a masked band, and at the
  timed frames, the timed kernel,
  the plain version and the counting kernel bit for bit, and the counting
  kernel's per-tile counts (path and shadow segments, sphere and triangle
  tests) against megakernel_visits_reference's, on the demo scene and the
  Cornell box with a bulb.
* the interactive app (phase 36): headless RayTracerInteraction sessions
  at 640x480, 8 spp a batch, depth 4, 32 samples (plain, NEE, adaptive
  tiles) held bit for bit against their chains driven by hand, a session
  with the four denoisers against the CPU port's stack, save_session /
  load_session on the card, and ``python -m tpu_rt_torch.app.run
  --headless``; the app's median batch and display-frame ms.
* the lax engine (phase 37, plain torch, no kernel): the depth-1 golden,
  the v1 parity test at 160x120/512spp/d4, RayTracer(linear=True) and
  RayTracer(mode="v1") on the demo scene at 640x480/8spp/d4 through the
  LBVH and against the CPU port at 160x120/2spp, the lax v2 mean against
  K1's, trace_ray and a linear-accumulation session on the card, and the
  lax frames' times with and without the LBVH.
* the parallel layer (phase 38): render_sharded over (2, 2) meshes of four
  cuda:0 entries with each engine (the megakernel on the demo scene at
  1080p/4spp, the cluster engine on 10k spheres at 1920x1024/4spp, the
  lax engine at 1080p/4spp), bit for bit the composition of the kernels'
  and the plain versions' bands; the lax mesh against the CPU's; two gloo
  processes on the card, two entries each, host-major and interleaved,
  bit for bit the single-process frame; a mesh over real GPUs where the
  machine has two; the sharded frames' times against the single-device
  frames' and their idle shares.

Each kernel must agree with its plain version bit for bit, segment counts
included. Every megakernel bound counts what its frame's rays did (the
counting instantiation's path and shadow segments and its shadow rays'
sphere and triangle tests, utils/roofline.py:megakernel_op_model), and
each K1 timing prints those counts, ns per test and the lanes a
warp-issued test carries. Every cluster-kernel bound counts the walk its
frame did (the counting instantiation's slab and primitive tests,
utils/roofline.py:cluster_op_model); each K2 timing prints what the walk
visited per segment,
its ns per visit and, beside the bound, a floor that does not depend on the
walk (``floor_ms``: ray setup, globals and super-super slab tests per
segment). Every phase raises on failure. The last line of standard output
is one JSON object naming the card; the line before it holds the card's
name and power limit, and the one before that the per-kernel JSON summary:
there ``ms`` is the kernel's device time per frame as torch.profiler
records it (K3's: the median of the CUDA events around its launches in
12 profiler windows, with the profiler's median as ``profiler_ms``),
``event_ms`` the same time from CUDA events around each of 20
launches (median), ``frame_ms`` the frame time over chained frames (CUDA
events), and ``plain_ms`` the plain version's frame time. Without
CUDA, or without the repository beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"

INTERACTIVE = dict(width=640, height=480, spp=8, max_depth=4)
BENCH = dict(width=1920, height=1080, spp=4, max_depth=4)
N_ACTIVE = 12  # quantize_count(9, 16): the demo scene's swept rows

# the cluster engine's scenes and camera (the JAX bench's large-scene row)
BIG = dict(n=10000, seed=1, spread=30.0)
HUGE = dict(n=100000, seed=1, spread=95.0)
BIG_CAM = dict(position=(0, 6, 40), target=(0, 0, -18))
PLAIN_SHAPE = dict(width=256, height=128, spp=4, max_depth=4)

# the mesh scenes and cameras (the JAX bench's terrain rows,
# benchmarks/bench_scenes.py:123-167)
CORNELL_CAM = dict(position=(0, 2, 2.5), target=(0, 2, -3))
CORNELL_ACTIVE = dict(n_active=4, n_tri_active=12)
TERRAIN_CAM = dict(position=(0, 6, 6), target=(0, 0, -10))
TERRAIN_10K = 72    # terrain_mesh(n=72): 10,082 triangles
TERRAIN_100K = 226  # terrain_mesh(n=226): 101,250 triangles
# the flags' cells: each flag alone and all three together
ALL_FLAGS = dict(enable_refraction=True, enable_dof=True, stratify=True)
FLAG_SETS = {"refraction": dict(enable_refraction=True),
             "DOF": dict(enable_dof=True), "stratify": dict(stratify=True),
             "all three": ALL_FLAGS}
GLASS = dict(albedo=(0.95, 0.95, 0.95), metallic=0.0, roughness=0.0, ior=1.5)
FIELD_CAM = dict(position=(0, 3, 14), target=(0, 0, -6))  # phase 8's pose


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def compare(kernel: torch.Tensor, plain: torch.Tensor) -> dict:
    d = (kernel - plain).abs()
    return {"frac_within_1e-4": float((d <= 1e-4).float().mean()),
            "mean_abs": float(d.mean()), "max_abs": float(d.max()),
            "mean_diff": float(kernel.mean() - plain.mean()),
            "n_differ": int((d > 0).sum())}


def check_exact(stats: dict, where: str, segs=None):
    """Kernel vs plain on the card: the kernels contract no FMA
    (``--fmad=false``) and the plain versions divide where the kernels do,
    so both must agree bit for bit, and so must their segment counts
    (``segs``: the two counts) where they are given."""
    check(stats["n_differ"] == 0, f"{where}: bit for bit: {stats}")
    if segs is not None:
        check(int(segs[0]) == int(segs[1]), f"{where}: segments {segs}")


def sm_clocks_under_load(enqueue, device) -> str:
    """``nvidia-smi``'s SM clock, its maximum and the power draw, read while
    the card runs the work ``enqueue()`` queues (about a second of it)."""
    with torch.cuda.device(device):
        enqueue()
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        torch.cuda.synchronize(device)
    return out


def fma_sass(lib_path: Path, nvcc: str):
    """Opcode counts of the FMA kernel's depth loop (of its backward
    branches, the one whose span holds the most FFMAs) from ``cuobjdump
    -sass``; None without cuobjdump."""
    import re
    from collections import Counter

    tool = Path(nvcc).parent / "cuobjdump"
    if not tool.is_file():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    m = re.search(r"Function : (\S*fma_chains\S*)\n(.*?)"
                  r"(?=\n\s*Function : |\Z)", out, re.S)
    check(m is not None, "cuobjdump lists the FMA kernel")
    code = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)"
        r"([^;]*);", m.group(2))]
    loops = []
    for addr, op, rest in code:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            loops.append(Counter(o for a, o, _ in code if lo <= a <= addr))
    check(bool(loops), "the FMA kernel has a loop")
    return max(loops, key=lambda c: c["FFMA"])


#: K3's timing: profiler windows, each of launches bracketed by CUDA events
K3_WINDOWS, K3_LAUNCHES = 12, 5


def fma_phase(lib_path: Path, nvcc: str, card: str, dev) -> tuple:
    """K3: the FMA microkernel against its plain version, the card's
    measured and theoretical f32 rates, and K3's own time and bound.
    Returns (measured FFMA/s, theoretical ops/s, the kernels-line entry)."""
    from tpu_rt_torch.utils import roofline as rl
    from tpu_rt_torch.utils.profiling import cuda_frame_ms, launch_ms

    rng = np.random.default_rng(33)
    attrs = rl.card_fp32(dev)
    n = rl.fma_grid(dev)
    print(f"[2b K3] {attrs.sms} SMs, maximum SM clock "
          f"{attrs.clock_khz / 1e3:.0f} MHz, {attrs.fma_blocks_per_sm} blocks "
          f"of {rl.FMA_BLOCK} threads per SM: one wave is {n} threads")
    blk = torch.from_numpy(rng.uniform(0.25, 1.0, (8, 128)).astype(
        np.float32)).to(dev)
    grid = torch.from_numpy(rng.uniform(0.25, 1.0, n).astype(
        np.float32)).to(dev)
    outs = {}
    for x, depth in ((blk, 8), (blk, 64), (blk, 1000), (grid, 64)):
        a = rl.fma_chains(x, depth)
        b = rl.fma_chains_reference(x, depth)
        n_off = int((a != b).sum())
        outs[tuple(x.shape), depth] = a
        print(f"[2b K3 vs plain] {tuple(x.shape)} depth {depth}: {n_off} of "
              f"{a.numel()} values differ; mean {float(a.mean()):.6g}")
        check(n_off == 0, f"K3 {tuple(x.shape)} depth {depth}: bit for bit")
        check(bool(torch.isfinite(a).all()), "K3: finite sums")
    check(not torch.equal(outs[(8, 128), 8], outs[(8, 128), 64]),
          "K3: depths 8 and 64 differ (the loop is not folded)")
    sass = fma_sass(lib_path, nvcc)
    if sass is None:
        print("[2b K3 sass] cuobjdump not found beside nvcc: not checked")
    else:
        other = sum(v for k, v in sass.items() if k != "FFMA")
        print(f"[2b K3 sass] the depth loop: {sass['FFMA']} FFMA and "
              f"{other} other instructions {dict(sass)}")
        check(sass["FFMA"] > 0 and sass["FFMA"] % (rl.CARRIES * 16) == 0,
              "K3: 512 FFMAs per unrolled step of the loop")
        check(other <= 0.01 * sass["FFMA"],
              "K3: loop overhead under 1% of its instructions")

    # the measurement, with its launches counted
    rl.fma_chains.launches = 0
    slope = rl.measure_fma_ops(device=dev)
    launches = rl.fma_chains.launches
    rate = slope.ops_per_s
    peak = rl.theoretical_fp32_ops(dev)
    d1, d2 = slope.depths
    clocks = sm_clocks_under_load(
        lambda: [rl.fma_chains(grid, d2) for _ in range(60)], dev)
    share = rate / peak
    print(f"[2b K3 rate] on {card}: measured {rate / 1e12:.4f} T FFMA/s "
          f"(slope of depths {d1} and {d2}: {slope.ms[0]:.4f} and "
          f"{slope.ms[1]:.4f} ms, median of 5 launches each after "
          f"{rl.FMA_WARMUP} warm-up launches, {n} threads x {rl.CARRIES} "
          f"chains); theoretical {peak / 1e12:.4f} T f32 instructions/s "
          f"({attrs.sms} SMs x {rl.FP32_LANES_PER_SM} lanes x "
          f"{attrs.clock_khz / 1e3:.0f} MHz); measured/theoretical "
          f"{share:.4f}; SM clock, max SM clock, power under K3: {clocks}")
    check(0.5 <= share <= 1.05,
          f"K3: measured rate {share:.4f} of the theoretical, outside "
          "[0.5, 1.05]")

    # K3's time: its launches' CUDA events. K3 runs at 0.98-0.99 of its
    # bound, and the profiler's durations of a whole window have read 1%
    # under the events of the same launches (and 2% over), so the gate
    # reads the card's own timer; the profiler's durations stand beside.
    windows = [launch_ms(lambda i: rl.fma_chains(grid, d2), "fma_chains",
                         K3_LAUNCHES, device=dev) for _ in range(K3_WINDOWS)]
    check(all(len(t) == len(e) for t, e in windows),
          "K3: torch.profiler recorded every launch of the FMA kernel")
    traced = [v for t, _ in windows for v in t]
    evented = [v for _, e in windows for v in e]
    k_ms = statistics.median(evented)
    prof_ms = statistics.median(traced)
    for w, (t, e) in enumerate(windows):
        print(f"[2b K3 launches] window {w}: profiler "
              f"{[round(v, 4) for v in t]} ms, CUDA events "
              f"{[round(v, 4) for v in e]} ms, ratio of medians "
              f"{statistics.median(t) / statistics.median(e):.5f}")
    print(f"[2b K3 launches] depth {d2}, {K3_WINDOWS} profiler windows of "
          f"{K3_LAUNCHES} launches: medians {prof_ms:.4f} / {k_ms:.4f} ms "
          f"(profiler / events), events {min(evented):.4f}-"
          f"{max(evented):.4f} ms, profiler {min(traced):.4f}-"
          f"{max(traced):.4f} ms; SM clock, max SM clock, power under K3: "
          f"{clocks}")
    # per thread: 32 seeds, 32 x depth FFMAs, 31 adds of the sum
    ops = n * (rl.CARRIES * d2 + 2 * rl.CARRIES - 1)
    b_ms, b_by = rl.bound_ms(ops, 8 * n, peak)
    b_meas = rl.bound_ms(ops, 8 * n, rate)[0]
    plain_depth = 64
    plain_ms = statistics.median(cuda_frame_ms(
        lambda i: rl.fma_chains_reference(grid, plain_depth), 3, device=dev))
    small_ms = statistics.median(cuda_frame_ms(
        lambda i: rl.fma_chains(grid, plain_depth), 7, device=dev))
    print(f"[2b K3 timing] depth {d2}, {n} threads: kernel {k_ms:.4f} ms "
          f"(CUDA events; profiler {prof_ms:.4f} ms; the rate's launches "
          f"{slope.ms[1]:.4f} ms); bound "
          f"{b_ms:.4f} ms ({b_by}, {ops / 1e9:.3f} G f32 ops at the "
          f"theoretical rate; {b_meas:.4f} ms at the measured), "
          f"{b_ms / k_ms:.4f} of the bound's rate; at depth {plain_depth}: "
          f"kernel frame {small_ms:.4f} ms, plain {plain_ms:.4f} ms "
          "(chained frames)")
    entry = {"name": "fma-microkernel", "route": "cuda",
             "source": "tpu_rt_torch/csrc/fma.cu",
             "replaces": "tpu_rt/utils/roofline.py:73",
             "launches": launches, "max_abs_err": 0.0,
             "ms": k_ms, "profiler_ms": prof_ms, "event_ms": slope.ms[1],
             "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "bound_ms_measured": b_meas,
             "library_ms": None,
             "shape": f"{n} threads x {rl.CARRIES} chains, depth {d2}",
             "plain_shape": f"{n} threads x {rl.CARRIES} chains, depth "
                            f"{plain_depth}",
             "frame_ms_at_plain_shape": small_ms,
             "fma_ops_per_s": rate, "theoretical_ops_per_s": peak,
             "sm_clocks": clocks}
    return rate, peak, entry


def glass_field(scene):
    """A glass field: every diffuse, non-emissive sphere of ``scene`` whose
    index is a positive multiple of 4 made glass (roughness 0, ior 1.5)."""
    idx = torch.arange(scene.capacity, device=scene.device)
    glass = ((idx % 4 == 0) & (idx > 0) & (scene.metallic <= 0)
             & (scene.emission.amax(dim=-1) <= 0))
    return scene._replace(roughness=torch.where(glass, 0.0, scene.roughness),
                          ior=torch.where(glass, 1.5, scene.ior))


def kernel_ms(by_kernel: dict, name: str) -> float:
    return sum(v for k, v in by_kernel.items() if name in k)


def event_kernel_ms(lib, entry: str, fn, frames: int, device) -> float:
    """Kernel device ms per launch from CUDA events recorded on the stream
    just before and just after each call of the library's ``entry`` in
    ``fn(i)``, over ``frames`` chained frames; median. The frames queue
    behind a spin of about 50 ms, so the host enqueues ahead of the card
    and no launch gap falls inside a pair. It checks the profiler's window,
    which sees 5 frames."""
    real = getattr(lib, entry)
    pairs = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = real(*args)
        end.record()
        pairs.append((start, end))
        return err

    with torch.cuda.device(device):
        fn(-1)
        torch.cuda.synchronize(device)
        setattr(lib, entry, timed)
        try:
            torch.cuda._sleep(100_000_000)
            for i in range(frames):
                fn(i)
            torch.cuda.synchronize(device)
        finally:
            setattr(lib, entry, real)
    check(len(pairs) == frames, f"{entry}: one launch per frame")
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def mean_gap(a: np.ndarray, b: np.ndarray):
    """(gap, standard error) of the whole-image means of two stacks of
    frames, with the frame-to-frame spread of each (tests/test_multilight.py
    :mean_gap_ok)."""
    ma = a.reshape(a.shape[0], -1).mean(1)
    mb = b.reshape(b.shape[0], -1).mean(1)
    return (float(abs(ma.mean() - mb.mean())),
            float(np.sqrt(ma.var() / len(ma) + mb.var() / len(mb))))


def device_line(what: str, by_kernel: dict, frame_ms: float,
                name: str) -> str:
    if not by_kernel:
        return (f"{what}: not measured (no device activity recorded by "
                "torch.profiler)")
    busy = sum(by_kernel.values())
    return (f"{what}: device busy {busy:.4f} ms/frame of {frame_ms:.4f} "
            f"(idle share {1 - busy / frame_ms:.3f}); {name} "
            f"{kernel_ms(by_kernel, name):.4f} ms, {len(by_kernel)} kernel "
            "names, top: " + ", ".join(
                f"{k[:40]} {v:.4f}" for k, v in sorted(
                    by_kernel.items(), key=lambda kv: -kv[1])[:3]))


#: phase 36's sessions: the GUI's size and the reference's batch defaults
APP = dict(width=640, height=480, samples_per_batch=8, max_depth=4,
           max_samples=32)
APP_TARGET = 0.02  # the adaptive session's noise target (phase 30's)
APP_METHODS = ("bilateral", "nlmeans", "gaussian", "median")


def app_phase(dev, card: str) -> dict:
    """[36 app]: the interactive runtime, tpu_rt_torch.app's headless
    RayTracerInteraction, on the card at 640x480, 8 spp a batch, depth 4,
    32 samples. Each session must end done at 32 samples with its
    accumulator bit for bit the chain driven by hand at the same seeds
    (RayTracer.render_device -> accumulate; with NEE; with adaptive_tiles +
    noise_target the masked chain through accumulate_tiled and the app's
    per-tile rule), K1 launched once a batch; every displayed frame of a
    session with the four denoisers carries all four, within 1 uint8 step
    of the CPU port's stack; a session round-trips through
    save_session/load_session on the card; ``python -m
    tpu_rt_torch.app.run --headless --samples 8`` exits 0. Returns the
    phase's times."""
    from tpu_rt_torch.api import RayTracer
    from tpu_rt_torch.app import RayTracerInteraction, SceneManager
    from tpu_rt_torch.ops.cluster import render_cluster
    from tpu_rt_torch.ops.megakernel import TILE, render_megakernel
    from tpu_rt_torch.render.display import display_stack, unpack_grid
    from tpu_rt_torch.render.frame import accumulate, accumulate_tiled

    t0 = time.perf_counter()
    w, h = APP["width"], APP["height"]
    spb, depth, total = (APP["samples_per_batch"], APP["max_depth"],
                         APP["max_samples"])

    def drain(rti, what):
        frames = []
        deadline = time.time() + 120
        while time.time() < deadline:
            f = rti.get_frame()
            if f is None:
                time.sleep(0.002)
                continue
            frames.append(f)
            if f.get("done"):
                return frames
        raise RuntimeError(f"check failed: {what}: no done frame in 120 s")

    def session(what, **settings):
        """One session to its done frame, the launch counts set to 0 just
        before it and read just after; returns (runtime, frames, K1
        launches, K2 launches)."""
        rti = RayTracerInteraction(w, h, device=dev)
        rti.settings.update({k: v for k, v in APP.items()
                             if k not in ("width", "height")})
        rti.settings.update(settings)
        render_megakernel.launches = render_cluster.launches = 0
        try:
            rti.start_rendering()
            frames = drain(rti, what)
        finally:
            rti.stop_rendering()
        torch.cuda.synchronize(dev)
        return (rti, frames, render_megakernel.launches,
                render_cluster.launches)

    def hand_chain(nee=False, adaptive=False):
        """The sessions' chain driven by hand: RayTracer(seed=0) on the
        interactive scene; with ``adaptive``, the masked chain under the
        app's per-tile rule. Returns (accumulator, masks rendered)."""
        rt = RayTracer(device=dev)
        rt.set_scene(SceneManager.create_interactive_scene())
        rt.set_nee(nee)
        if not adaptive:
            acc, n = None, 0
            for _ in range(total // spb):
                acc, n = accumulate(acc, n, rt.render_device(w, h, spb, depth),
                                    spb)
            return acc, None
        n_tiles = -(-(w * h) // TILE)
        mask = np.ones(n_tiles, np.int32)
        streak = np.zeros(n_tiles, np.int32)
        acc = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        counts = torch.zeros((n_tiles,), dtype=torch.float32, device=dev)
        masks = []
        while float(counts.max()) < total and mask.any():
            masks.append(mask)
            m = torch.from_numpy(mask).to(dev)
            batch = rt.render_device(w, h, spb, depth, tile_mask=m)
            acc, counts, change = accumulate_tiled(acc, counts, batch, m, spb,
                                                   TILE)
            active = mask > 0
            streak = np.where(active & (change.cpu().numpy() < APP_TARGET),
                              streak + 1, 0)
            mask = (active & (streak < 2)).astype(np.int32)
        return acc, masks

    def shown(frames):
        return [f for f in frames if f.get("is_raytracing")]

    def ms(frames, key):
        return 1e3 * statistics.median(f[key] for f in shown(frames))

    times = {}
    # (a) the progressive session against its chain
    rti, frames, k1, k2 = session("progressive session")
    acc, _ = hand_chain()
    stats = compare(rti._acc_dev, acc)
    last = shown(frames)[-1]
    print(f"[36 app] RayTracerInteraction(640, 480, device={dev}), 8 spp a "
          f"batch, depth 4, 32 samples: done at {rti.total_samples} "
          f"(converged {frames[-1]['converged']}), {len(shown(frames))} "
          f"frames; megakernel launches {k1}, cluster launches {k2}; "
          "accumulator vs RayTracer.render_device -> accumulate at the same "
          f"seeds: {stats}")
    check(rti.total_samples == total and last["samples"] == total,
          "the session ended at 32 samples")
    check(k1 == total // spb and k2 == 0,
          "the session launched K1 once a batch, and never K2")
    check_exact(stats, "app session accumulator")
    ref_stack = display_stack(acc, 1.5, as_uint8=True).cpu().numpy()
    check(np.array_equal(last["display"], ref_stack[0])
          and np.array_equal(last["enhanced"], ref_stack[1]),
          "the last frame is the display stack of the final accumulator")
    times["batch_ms"] = ms(frames, "render_time")
    times["frame_ms"] = ms(frames, "frame_latency")
    session_acc = rti._acc_dev
    # one app frame's work driven by hand on this thread, batch by batch
    # (render, merge, display stack, pull), without the worker thread, its
    # lock, its sleeps and its double buffering
    rt = RayTracer(device=dev)
    rt.set_scene(SceneManager.create_interactive_scene())
    acc_h, n_h, per = None, 0, []
    for _ in range(total // spb):
        t1 = time.perf_counter()
        acc_h, n_h = accumulate(acc_h, n_h, rt.render_device(w, h, spb, depth),
                                spb)
        display_stack(acc_h, 1.5, as_uint8=True).cpu()
        per.append(time.perf_counter() - t1)
    times["chain_ms"] = 1e3 * statistics.median(per)

    # (b) NEE
    rti_n, frames_n, k1, k2 = session("NEE session", nee=True)
    acc_n, _ = hand_chain(nee=True)
    stats = compare(rti_n._acc_dev, acc_n)
    print(f"[36 app] nee=True: done at {rti_n.total_samples}; megakernel "
          f"launches {k1}, cluster launches {k2}; accumulator vs the chain "
          f"with set_nee(True): {stats}")
    check(rti_n.total_samples == total and k1 == total // spb and k2 == 0,
          "NEE session: 32 samples, K1 once a batch")
    check_exact(stats, "app NEE session accumulator")

    # (c) adaptive tiles + noise target
    rti_a, frames_a, k1, k2 = session("adaptive session", adaptive_tiles=True,
                                      noise_target=APP_TARGET)
    acc_a, masks = hand_chain(adaptive=True)
    stats = compare(rti_a._acc_dev, acc_a)
    n_tiles = masks[0].shape[0]
    print(f"[36 app] adaptive_tiles + noise_target {APP_TARGET}: "
          f"{len(masks)} batches, active tiles per batch "
          f"{[int(m.sum()) for m in masks]} of {n_tiles}, frames' active "
          f"tiles {[f['active_tiles'] for f in shown(frames_a)]}; megakernel "
          f"launches {k1}; accumulator vs the masked chain: {stats}")
    check(k1 == len(masks) and k2 == 0, "adaptive: K1 once a batch")
    check(any(0 < int(m.sum()) < n_tiles for m in masks),
          "adaptive: a batch rendered under a partial mask")
    check_exact(stats, "app adaptive session accumulator")

    # (d) the denoiser grid on every displayed frame
    rti_d, frames_d, k1, _ = session("denoiser session", max_samples=2 * spb,
                                     show_denoisers=True,
                                     selected_denoisers=list(APP_METHODS))
    check(len(shown(frames_d)) == 2 and all(
        set(f["denoised"]) == set(APP_METHODS) for f in shown(frames_d)),
        "every displayed frame carries the four denoisers")
    plain = display_stack(rti_d._acc_dev.cpu(), 1.5, methods=APP_METHODS,
                          as_uint8=True, grid_scale=2).numpy()
    last = shown(frames_d)[-1]
    check(np.array_equal(last["display"], plain[0])
          and np.array_equal(last["enhanced"], plain[1]),
          "denoiser session: display and enhanced equal the CPU port's")
    cpu_rows = unpack_grid(plain[2], APP_METHODS, 2)
    worst = {}
    for m in APP_METHODS:
        d = np.abs(last["denoised"][m].astype(int) - cpu_rows[m].astype(int))
        worst[m] = (int(d.max()), float((d == 0).mean()))
        check(last["denoised"][m].shape == (h // 2, w // 2, 3)
              and int(d.max()) <= 1, f"{m}: within 1 uint8 step of the CPU")
    times["denoise_batch_ms"] = ms(frames_d, "render_time")
    times["denoise_frame_ms"] = ms(frames_d, "frame_latency")
    print(f"[36 app] four denoisers (grid_scale 2): every displayed frame "
          f"carries {sorted(APP_METHODS)}; the last frame vs the CPU port's "
          f"stack, (max uint8 difference, share equal): {worst}")

    # (e) a session through save_session / load_session on the card
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "session.npz")
        rti.save_session(path)
        r2 = RayTracerInteraction(w, h, device=dev)
        try:
            r2.load_session(path)  # at max_samples: resumes to done at once
            drain(r2, "restored session")
            restored = (r2._acc_dev.device == dev
                        and bool(torch.equal(r2._acc_dev, session_acc))
                        and r2.total_samples == total)
            r2.settings["max_samples"] = total + spb
            r2.resume_rendering()
            drain(r2, "resumed session")
        finally:
            r2.stop_rendering()
    print(f"[36 app] save_session -> load_session on {dev}: accumulator "
          f"and samples equal {restored}; resumed to {r2.total_samples}")
    check(restored, "the restored session's accumulator is the saved one")
    check(r2.total_samples == total + spb, "the resumed session went on")

    # (f) the launcher, as a user starts it
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "app.png"
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_rt_torch.app.run", "--headless",
             "--samples", "8", "--output", str(png)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        ok = proc.returncode == 0 and png.exists()
    print(f"[36 app] python -m tpu_rt_torch.app.run --headless --samples 8: "
          f"rc {proc.returncode}, image written {ok}, "
          f"{time.perf_counter() - t1:.1f} s; its last line: "
          f"{proc.stdout.strip().splitlines()[-1:]}")
    check(ok, f"the headless launcher: {proc.stderr[-2000:]}")
    times["seconds"] = time.perf_counter() - t0
    print(f"[36 app timing] {card}: batch {times['batch_ms']:.4f} ms, "
          f"display frame {times['frame_ms']:.4f} ms (medians over the "
          "progressive session's frames: render_time, frame_latency); the "
          "same batch, merge, display stack and pull driven by hand "
          f"{times['chain_ms']:.4f} ms (median of {total // spb}); with "
          f"four denoisers batch {times['denoise_batch_ms']:.4f} ms, "
          f"display frame {times['denoise_frame_ms']:.4f} ms; phase "
          f"{times['seconds']:.1f} s")
    return times


LAX = dict(width=640, height=480, spp=8, max_depth=4)  # the GUI's batch
LAX_CPU = dict(width=160, height=120, spp=2, max_depth=4)  # held vs the CPU


def lax_phase(dev, card: str) -> dict:
    """[37 lax]: the lax engine (ops/integrator.py, plain torch, no kernel)
    on the card. (a) render(engine="lax", jitter=False, max_depth=1) of the
    demo scene at 160x120 against the C++ golden to 1e-6; (b) the v1
    parity test at its full size, 160x120/512spp/d4 at seeds 7 and 8
    against the C++ golden (cross RMSE under 1.15x the two-seed floor, mean
    within 2e-3); (c) RayTracer(linear=True) and RayTracer(mode="v1") on
    the demo scene at 640x480/8spp/d4 through the LBVH, 4 batches, and the
    same tracers against the CPU port at 160x120/2spp at the same seeds
    (threefry bits equal; 99.9% of values within 1e-4, segments within
    0.1%); (d) the lax v2 linear mean against K1's linear mean at
    64x48/64spp/d4, within 3 SE per channel; (e) trace_ray on the card
    against the CPU, and a RayTracerInteraction(linear_accumulation=True)
    session of 4 frames; (f) timings (CUDA events over chained frames:
    median and spread). Nothing falls back to the CPU: every tensor of the
    card's runs lies on the card. Returns the phase's times."""
    from tpu_rt_torch.api import Ray, RayTracer, Vector3
    from tpu_rt_torch.api.compat import batch_seed
    from tpu_rt_torch.app import RayTracerInteraction, SceneManager
    from tpu_rt_torch.core import rng
    from tpu_rt_torch.core.types import demo_scene, make_camera
    from tpu_rt_torch.ops.cluster import render_cluster
    from tpu_rt_torch.ops.megakernel import render_megakernel
    from tpu_rt_torch.render.frame import render
    from tpu_rt_torch.utils.profiling import cuda_frame_ms

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    scene = demo_scene(device=dev)

    def cam(w, h, device=dev):
        return make_camera(aspect=w / h, device=device)

    # (a) the deterministic golden
    gold = np.load(GOLDENS / "ref_depth1_160x120.npy")
    img = render(scene, cam(160, 120), 0, width=160, height=120, spp=1,
                 max_depth=1, jitter=False, engine="lax")
    check(img.device == dev, "the lax engine renders on the card")
    err = float(np.abs(img.cpu().numpy() - gold).max())
    print(f"[37 lax golden] render(engine='lax', jitter=False, max_depth=1) "
          f"160x120 vs the C++ golden: max abs {err:.3g}")
    check(err <= 1e-6, "lax depth-1 golden within 1e-6")

    # (b) the v1 parity test at its full size
    ref = np.load(GOLDENS / "ref_render_160x120_512spp.npy")
    a, b = (render(scene, cam(160, 120), s, width=160, height=120, spp=512,
                   max_depth=4, mode="v1").cpu().numpy() for s in (7, 8))
    rmse_ref = float(np.sqrt(((a - ref) ** 2).mean()))
    floor = float(np.sqrt(((a - b) ** 2).mean()))
    gap = abs(float(a.mean() - ref.mean()))
    print(f"[37 lax v1 parity] 160x120/512spp/d4 seeds 7, 8: cross RMSE vs "
          f"the C++ golden {rmse_ref:.6f}, two-seed floor {floor:.6f} "
          f"(ratio {rmse_ref / floor:.4f}), mean gap {gap:.6f}")
    check(rmse_ref < 1.15 * floor, "v1 parity: cross RMSE under 1.15x floor")
    check(gap < 2e-3, "v1 parity: mean within 2e-3")

    # (c) the slice at full width, and against the CPU port
    k_cpu = rng.bits(rng.fold_in(rng.key(5, device=cpu), 101), (4096, 3))
    k_dev = rng.bits(rng.fold_in(rng.key(5, device=dev), 101), (4096, 3))
    check(torch.equal(k_dev.cpu(), k_cpu), "threefry bits: card == CPU")
    tracers = {}
    for label, kw in (("linear", dict(linear=True)), ("v1", dict(mode="v1"))):
        rt = RayTracer(device=dev, **kw)
        rt.set_scene(SceneManager.create_interactive_scene())
        render_megakernel.launches = render_cluster.launches = 0
        batches = [rt.render_device(**{k: LAX[k] for k in ("width",
                                                            "height")},
                                    samples_per_pixel=LAX["spp"],
                                    max_depth=LAX["max_depth"])
                   for _ in range(4)]
        torch.cuda.synchronize(dev)
        ok = all(x.device == dev and x.shape == (480, 640, 3)
                 and bool(torch.isfinite(x).all()) for x in batches)
        peak = max(float(x.max()) for x in batches)
        print(f"[37 lax main path] RayTracer({label}) demo scene "
              f"640x480/8spp/d4 x4: engine {rt._last_engine}, LBVH "
              f"{rt._last_use_bvh}, K1/K2 launches "
              f"{render_megakernel.launches}/{render_cluster.launches}, "
              f"finite on the card {ok}, peak {peak:.4f}")
        check(rt._last_engine == "lax" and rt._last_use_bvh is True,
              f"RayTracer({label}) takes the lax engine through the LBVH")
        check(ok and render_megakernel.launches == 0
              and render_cluster.launches == 0, f"RayTracer({label}) batches")
        check((peak > 1.0) == (label == "linear"),
              f"RayTracer({label}): linear radiance only when linear")
        tracers[label] = kw
        # the same tracer on both devices at 160x120/2spp, same seeds
        fracs, segs = [], []
        for f in range(2):
            args = dict(LAX_CPU, seed=batch_seed(1, f), with_stats=True,
                        engine="lax", use_bvh=True,
                        mode=kw.get("mode", "v2"),
                        gamma=not kw.get("linear", False))
            outs = [render(demo_scene(device=d_), cam(160, 120, d_),
                           **args) for d_ in (dev, cpu)]
            diff = (outs[0][0].cpu() - outs[1][0]).abs()
            fracs.append(float((diff <= 1e-4).float().mean()))
            segs.append((int(outs[0][1]), int(outs[1][1])))
        print(f"[37 lax vs CPU] RayTracer({label})'s batches 0, 1 at "
              f"160x120/2spp/d4: values within 1e-4 {fracs}, segments "
              f"(card, CPU) {segs}")
        check(min(fracs) >= 0.999, f"{label}: card vs CPU values")
        check(all(abs(x - y) <= 0.001 * y for x, y in segs),
              f"{label}: card vs CPU segments")

    # (d) the lax v2 mean against K1's, linear, 64x48/64spp/d4 in 16
    # independent batches of 4 samples each (the SE from their spread)
    c48 = cam(64, 48)
    means = {}
    for name, fn in (
            ("lax", lambda s: render(scene, c48, s, width=64, height=48,
                                     spp=4, max_depth=4, gamma=False,
                                     engine="lax")),
            ("K1", lambda s: render_megakernel(scene, c48, s, width=64,
                                               height=48, spp=4, max_depth=4,
                                               gamma=False, n_active=12))):
        per = torch.stack([fn(3000 + 17 * i).mean(dim=(0, 1))
                           for i in range(16)]).double().cpu()
        means[name] = (per.mean(0), per.std(0) / 4.0)
    se = torch.sqrt(means["lax"][1] ** 2 + means["K1"][1] ** 2)
    z = ((means["lax"][0] - means["K1"][0]).abs() / se).tolist()
    print(f"[37 lax vs K1] linear channel means 64x48/64spp/d4: lax "
          f"{means['lax'][0].tolist()}, K1 {means['K1'][0].tolist()}, "
          f"|gap| / SE {z}")
    check(max(z) <= 3.0, "lax v2 mean within 3 SE of K1's")

    # (e) trace_ray and a linear-accumulation session on the card
    rays = [((0.0, 2.0, 5.0), (0.0, -1.5, -8.0)),
            ((0.0, 2.0, 5.0), (0.0, 1.0, -6.0)),
            ((0.0, 2.0, 5.0), (2.0, -1.5, -8.0))]
    got = {}
    for where, d_ in (("card", dev), ("cpu", cpu)):
        rt = RayTracer(seed=3, device=d_)
        rt.set_scene(SceneManager.create_interactive_scene())
        got[where] = [rt.trace_ray(Ray(Vector3(*o), Vector3(*v)), 0, 4)
                      for o, v in rays]
    tr = [[round(c, 6) for c in (v.x, v.y, v.z)] for v in got["card"]]
    close = all(abs(p - q) <= 1e-4 * max(1.0, abs(q))
                for u, v in zip(got["card"], got["cpu"])
                for p, q in zip((u.x, u.y, u.z), (v.x, v.y, v.z)))
    print(f"[37 lax trace_ray] on the card {tr}; equal to the CPU's within "
          f"1e-4: {close}")
    check(close, "trace_ray on the card vs the CPU")
    rti = RayTracerInteraction(640, 480, linear_accumulation=True, device=dev)
    rti.settings.update(max_samples=32, samples_per_batch=8, max_depth=4)
    frames = []
    try:
        rti.start_rendering()
        deadline = time.time() + 120
        while time.time() < deadline:
            f = rti.get_frame()
            if f is None:
                time.sleep(0.002)
                continue
            frames.append(f)
            if f.get("done"):
                break
    finally:
        rti.stop_rendering()
    shown = [f for f in frames if f.get("is_raytracing")]
    acc = rti._acc_dev
    ok = (bool(frames) and frames[-1].get("done") and rti.total_samples == 32
          and acc.device == dev and bool(torch.isfinite(acc).all())
          and float(acc.max()) > 1.0)
    print(f"[37 lax session] RayTracerInteraction(640, 480, "
          f"linear_accumulation=True, device={dev}): {len(shown)} frames, "
          f"done at {rti.total_samples}, engine "
          f"{rti.ray_tracer._last_engine}, accumulator on the card, linear "
          f"(peak {float(acc.max()):.4f}): {ok}")
    check(ok and len(shown) == 4 and rti.ray_tracer._last_engine == "lax",
          "the linear-accumulation session on the card")

    # (f) timings
    times = {"batch_ms": 1e3 * statistics.median(
        f["render_time"] for f in shown)}
    c640 = cam(640, 480)
    for label, kw in (("lax v2 linear, LBVH", dict(use_bvh=True,
                                                   gamma=False)),
                      ("lax v2 linear, dense", dict(gamma=False)),
                      ("lax v1, LBVH", dict(use_bvh=True, mode="v1"))):
        ms = cuda_frame_ms(lambda i, kw=kw: render(
            scene, c640, 500 + i, engine="lax", **LAX, **kw), 7, device=dev)
        times[label] = ms
        print(f"[37 lax timing] {card}: {label} demo 640x480/8spp/d4: "
              f"median {statistics.median(ms):.4f} ms, spread "
              f"{min(ms):.4f}-{max(ms):.4f} ms (7 chained frames)")
    times["seconds"] = time.perf_counter() - t0
    print(f"[37 lax timing] {card}: linear-accumulation session batch "
          f"{times['batch_ms']:.4f} ms (median render_time of its 4 "
          f"frames); phase {times['seconds']:.1f} s")
    return times


#: phase 38's frames: the JAX bench's 1080p/4spp/d4, and for the cluster
#: engine 1920x1024, whose 512-row bands lie on K2's 32-row grid
PAR_K2 = dict(width=1920, height=1024, spp=4, max_depth=4)
PAR_PLAIN = dict(width=256, height=128, spp=4, max_depth=4)
PAR_CPU = dict(width=64, height=32, spp=4, max_depth=4)
PAR_SEED = 11

#: phase 38 (d): one process of a two-process gloo group on the card, with
#: two entries of cuda:0; renders the host-major and the interleaved (2, 2)
#: meshes and saves each gathered frame and the shards it rendered
PAR_WORKER = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=120))
from tpu_rt_torch.core import rng
from tpu_rt_torch.core.types import demo_scene, make_camera
from tpu_rt_torch.parallel import (group_devices_by_host, make_mesh,
                                   make_multihost_mesh, render_sharded)

dev = torch.device("cuda", 0)
mine = [dev] * 2
hosts = group_devices_by_host(mine)
meshes = {"host-major": make_multihost_mesh(devices=mine, sample_per_host=2),
          "interleaved": make_mesh(2, 2, devices=[d for pair in zip(*hosts)
                                                  for d in pair])}
scene = demo_scene(device=dev)
cam = make_camera(aspect=%(w)d / %(h)d, device=dev)
res = {}
for name, mesh in meshes.items():
    for engine, extra in (("pallas", dict(n_active=%(n_active)d)),
                          ("lax", {})):
        img = render_sharded(scene, cam, rng.key(%(seed)d, device=dev), mesh,
                             engine=engine, **%(bench)r, **extra)
        res[f"{name} {engine}"] = img.gather(torch.device("cpu")).numpy()
        res[f"{name} {engine} shards"] = np.asarray(img.shards)
np.savez(out, **res)
dist.destroy_process_group()
"""


def parallel_phase(dev, card: str) -> dict:
    """[38 parallel]: tpu_rt_torch.parallel.render_sharded on the card,
    over (2, 2) meshes of four cuda:0 entries (one card: the shards run one
    after another on its stream). (a) engine="pallas", the demo scene at
    1920x1080/4spp/d4: K1 launched once a shard, the frame bit for bit the
    composition of render_megakernel's bands (each shard's seed, summed in
    sample order, averaged, gamma'd), and at 256x128 the composition of the
    plain version's bands; (b) engine="cluster", 10k random spheres at
    1920x1024/4spp/d4, the same with render_cluster; (c) engine="lax" (the
    default) at 1920x1080/4spp/d4, and the card against the CPU port at
    64x32/4spp (99.9% of values within 1e-4, segments within 0.1%); (d) two
    gloo processes on the card, two cuda:0 entries each, host-major and
    interleaved, every gathered frame bit for bit the single-process
    frame; (e) with two or more GPUs, a mesh over the real GPUs bit for bit
    the virtual mesh of the same shape. For (a)-(c): the sharded frame's ms
    against the single-device frame's (CUDA events over chained frames,
    median) and the device's idle share (torch.profiler). Returns the
    phase's times."""
    import socket

    from tpu_rt_torch.core import rng
    from tpu_rt_torch.core import vecmath as vm
    from tpu_rt_torch.core.scenes import random_spheres
    from tpu_rt_torch.core.types import demo_scene, make_camera
    from tpu_rt_torch.ops.cluster import (
        render_cluster, render_cluster_reference)
    from tpu_rt_torch.ops.megakernel import (
        render_megakernel, render_megakernel_reference)
    from tpu_rt_torch.parallel import make_mesh, render_sharded
    from tpu_rt_torch.parallel.mesh import shard_keys, shard_seed
    from tpu_rt_torch.render.frame import render
    from tpu_rt_torch.utils.profiling import cuda_frame_ms, device_work

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    times = {}
    mesh4 = make_mesh(2, 2, devices=[dev] * 4)
    demo = demo_scene(device=dev)
    big = random_spheres(**BIG, device=dev)

    def key(device=dev):
        return rng.key(PAR_SEED, device=device)

    def composition(render_band, scene, cam, shape, **kw):
        """The sharded frame by hand: each shard's band at its seed, the
        bands of a mesh row summed in sample order, averaged, gamma'd."""
        keys = shard_keys(key(cpu), 2, 2)
        rows = shape["height"] // 2
        out = []
        for ti in range(2):
            acc = None
            for si in range(2):
                band = render_band(
                    scene, cam, shard_seed(keys[ti, si]), gamma=False,
                    rows=rows, row_offset=ti * rows,
                    **dict(shape, spp=shape["spp"] // 2), **kw)
                acc = band if acc is None else acc + band
            out.append(acc / torch.tensor(2.0, device=dev))
        img = torch.cat(out)
        return torch.clamp(vm.sqrt(torch.clamp_min(img, 0.0)), 0.0, 1.0)

    def timing(label, sharded, single, frames):
        """Sharded and single-device frame ms, and each one's idle share."""
        row = {}
        for what, fn in (("sharded", sharded), ("single", single)):
            ms = statistics.median(cuda_frame_ms(fn, frames, device=dev))
            busy = device_work(fn, max(2, frames // 2), device=dev)[0]
            row[what] = (ms, busy, 1 - busy / ms)
        (s_ms, s_busy, s_idle), (d_ms, d_busy, d_idle) = (row["sharded"],
                                                          row["single"])
        print(f"[38 parallel timing] {card}: {label}: sharded (2, 2) frame "
              f"{s_ms:.4f} ms (device busy {s_busy:.4f}, idle share "
              f"{s_idle:.3f}), single-device frame {d_ms:.4f} ms (busy "
              f"{d_busy:.4f}, idle {d_idle:.3f}), ratio {s_ms / d_ms:.4f} "
              f"(median of {frames} chained frames); "
              f"{time.perf_counter() - t0:.1f} s into the phase")
        times[label] = row

    # (a) K1 bands
    cam_b = make_camera(aspect=BENCH["width"] / BENCH["height"], device=dev)
    k1_kw = dict(engine="pallas", n_active=N_ACTIVE)
    render_megakernel.launches = 0
    out = render_sharded(demo, cam_b, key(), mesh4, **BENCH, **k1_kw)
    frame_a = out.gather()
    launches = render_megakernel.launches
    ref = composition(render_megakernel, demo, cam_b, BENCH,
                      n_active=N_ACTIVE)
    stats = compare(frame_a, ref)
    print(f"[38 parallel pallas] render_sharded(engine='pallas') demo "
          f"1920x1080/4spp/d4 on (2, 2) x cuda:0: K1 launches {launches}, "
          f"shards {out.shards}, segments {out.segments}; vs "
          f"render_megakernel's bands {stats}")
    check(launches == 4, "pallas: K1 launched once a shard")
    check_exact(stats, "pallas: the sharded frame vs its K1 bands")
    cam_p = make_camera(aspect=2.0, device=dev)
    small = render_sharded(demo, cam_p, key(), mesh4, **PAR_PLAIN,
                           **k1_kw).gather()
    stats = compare(small, composition(render_megakernel_reference, demo,
                                       cam_p, PAR_PLAIN, n_active=N_ACTIVE))
    print(f"[38 parallel pallas] 256x128/4spp/d4: vs the plain version's "
          f"bands {stats}")
    check_exact(stats, "pallas: the sharded frame vs its plain bands")
    timing("pallas, demo 1920x1080/4spp/d4",
           lambda i: render_sharded(demo, cam_b, key(), mesh4, **BENCH,
                                    **k1_kw),
           lambda i: render_megakernel(demo, cam_b, 2**31 - 2, **BENCH,
                                       n_active=N_ACTIVE), 7)

    # (b) K2 bands
    cam_k = make_camera(aspect=PAR_K2["width"] / PAR_K2["height"],
                        device=dev, **BIG_CAM)
    render_cluster.launches = 0
    out = render_sharded(big, cam_k, key(), mesh4, **PAR_K2,
                         engine="cluster")
    frame_b = out.gather()
    launches = render_cluster.launches
    stats = compare(frame_b, composition(render_cluster, big, cam_k,
                                         PAR_K2))
    print(f"[38 parallel cluster] render_sharded(engine='cluster') 10k "
          f"spheres 1920x1024/4spp/d4 on (2, 2) x cuda:0: K2 launches "
          f"{launches}, segments {out.segments}; vs render_cluster's bands "
          f"{stats}")
    check(launches >= 4, "cluster: K2 launched for every shard")
    check_exact(stats, "cluster: the sharded frame vs its K2 bands")
    cam_q = make_camera(aspect=2.0, device=dev, **BIG_CAM)
    small = render_sharded(big, cam_q, key(), mesh4, **PAR_PLAIN,
                           engine="cluster").gather()
    stats = compare(small, composition(render_cluster_reference, big, cam_q,
                                       PAR_PLAIN))
    print(f"[38 parallel cluster] 256x128/4spp/d4: vs the plain version's "
          f"bands {stats}")
    check_exact(stats, "cluster: the sharded frame vs its plain bands")
    timing("cluster, 10k spheres 1920x1024/4spp/d4",
           lambda i: render_sharded(big, cam_k, key(), mesh4, **PAR_K2,
                                    engine="cluster"),
           lambda i: render_cluster(big, cam_k, 2**31 - 2, **PAR_K2), 5)

    # (c) the lax engine
    render_megakernel.launches = render_cluster.launches = 0
    out = render_sharded(demo, cam_b, key(), mesh4, **BENCH)
    frame_c = out.gather()
    peak = float(frame_c.max())
    ok = (frame_c.device == dev
          and frame_c.shape == (BENCH["height"], BENCH["width"], 3)
          and bool(torch.isfinite(frame_c).all()) and 0.0 < peak <= 1.0)
    print(f"[38 parallel lax] render_sharded (engine 'lax') demo "
          f"1920x1080/4spp/d4 on (2, 2) x cuda:0: on the card, finite, in "
          f"[0, 1] (peak {peak:.4f}): {ok}; segments {out.segments}; K1/K2 "
          f"launches {render_megakernel.launches}/{render_cluster.launches}")
    check(ok and render_megakernel.launches == 0
          and render_cluster.launches == 0, "lax: the sharded frame")
    fracs, segs = [], []
    for flags in ({}, dict(nee=True, stratify=True, enable_dof=True,
                           use_bvh=True)):
        outs = []
        for d_ in (dev, cpu):
            img = render_sharded(
                demo_scene(device=d_),
                make_camera(aspect=2.0, aperture=0.05, focus_dist=8.0,
                            device=d_),
                key(d_), make_mesh(2, 2, devices=[d_] * 4), **PAR_CPU,
                **flags)
            outs.append((img.gather(cpu), img.segments))
        diff = (outs[0][0] - outs[1][0]).abs()
        fracs.append(float((diff <= 1e-4).float().mean()))
        segs.append((outs[0][1], outs[1][1]))
    print(f"[38 parallel lax vs CPU] 64x32/4spp/d4 on (2, 2), no flags and "
          f"NEE + stratify + DOF + LBVH: values within 1e-4 {fracs}, "
          f"segments (card, CPU) {segs}")
    check(min(fracs) >= 0.999, "lax: card vs CPU values")
    check(all(abs(x - y) <= 0.001 * y for x, y in segs),
          "lax: card vs CPU segments")
    timing("lax, demo 1920x1080/4spp/d4",
           lambda i: render_sharded(demo, cam_b, key(), mesh4, **BENCH),
           lambda i: render(demo, cam_b, PAR_SEED, engine="lax", **BENCH), 3)

    # (d) two gloo processes on the card
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    script = PAR_WORKER % dict(w=BENCH["width"], h=BENCH["height"],
                               n_active=N_ACTIVE, seed=PAR_SEED, bench=BENCH)
    t_d = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        procs = [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(port),
             str(Path(tmp) / f"out{r}.npz")], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"gloo process {r}: {err[-2000:]}")
        res = [dict(np.load(Path(tmp) / f"out{r}.npz")) for r in range(2)]
    want = {"pallas": frame_a.cpu().numpy(), "lax": frame_c.cpu().numpy()}
    for name in ("host-major", "interleaved"):
        for engine, frame in want.items():
            n_off = [int((x[f"{name} {engine}"] != frame).sum()) for x in res]
            shards = [[tuple(int(v) for v in s)
                       for s in x[f"{name} {engine} shards"]] for x in res]
            print(f"[38 parallel gloo] two processes x two cuda:0 entries, "
                  f"{name} (2, 2), {engine}: shards per process {shards}; "
                  f"values differing from the single-process frame "
                  f"{n_off}")
            check(n_off == [0, 0], f"gloo {name} {engine}: bit for bit")
            check(sorted(shards[0] + shards[1]) == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]
                  and len(shards[0]) == 2,
                  f"gloo {name} {engine}: each process renders its own 2")
    times["gloo_s"] = time.perf_counter() - t_d

    # (e) the real GPUs of this machine
    n_gpu = torch.cuda.device_count()
    if n_gpu >= 2:
        real = make_mesh(n_gpu, 1)
        virtual = make_mesh(n_gpu, 1, devices=[dev] * n_gpu)
        h = 32 * n_gpu
        a, b = (render_sharded(demo, cam_p, key(), m, width=256, height=h,
                               spp=4, max_depth=4, **k1_kw).gather(cpu)
                for m in (real, virtual))
        check(torch.equal(a, b), "real GPUs vs the virtual mesh")
        print(f"[38 parallel GPUs] ({n_gpu}, 1) over the real GPUs equals "
              "the virtual mesh bit for bit")
    else:
        print(f"[38 parallel GPUs] one GPU here ({n_gpu}): a mesh over real "
              "GPUs did not run")
    times["seconds"] = time.perf_counter() - t0
    print(f"[38 parallel] phase {times['seconds']:.1f} s (gloo processes "
          f"{times['gloo_s']:.1f} s)")
    return times


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (ROOT / "tpu_rt_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no tpu_rt_torch package in {ROOT}")
    sys.path.insert(0, str(ROOT))

    import tpu_rt_torch
    from tpu_rt_torch.api.compat import (
        Material, RayTracer, Scene, Sphere, Vector3, batch_seed)
    from tpu_rt_torch.app.run import EXPOSURE, demo_api_scene
    from tpu_rt_torch.core.scenes import random_spheres
    from tpu_rt_torch.kernels import build
    from tpu_rt_torch.ops.cluster import (
        build_clusters, order_clusters, render_cluster,
        render_cluster_reference)
    from tpu_rt_torch.ops.megakernel import (
        render_megakernel, render_megakernel_reference)
    import tpu_rt_torch.ops.cluster as cluster_mod
    import tpu_rt_torch.ops.megakernel as mk_mod
    from tpu_rt_torch.render.display import display_stack
    from tpu_rt_torch.render.frame import accumulate, render
    from tpu_rt_torch.utils.profiling import (
        cuda_frame_ms, device_ms_by_kernel, traced_mrays_per_s)
    from tpu_rt_torch.utils.roofline import (
        bound_ms, cluster_floor_per_segment, cluster_op_model,
        megakernel_bytes, megakernel_op_model, path_ops)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- 1. the card ----
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[1 card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, nvcc {nvcc.stdout.strip().splitlines()[-1]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = build.build()
    lib = build.load()
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    log = lib_path.with_suffix(".log").read_text()
    for line in log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            print(f"[2 build] {line.strip()}")
    k1_builds = build.ptxas_lines(log)
    for line in k1_builds:
        print(f"[2 build] K1 <kTris, kFlags, kNee, kCount> {line}")
    check(len(k1_builds) == 10, "ptxas reported the 6 timed and 4 counting "
          "K1 instantiations")

    # ---- 2b. K3, the FMA microkernel: the card's measured f32 rate,
    # beside the theoretical rate that every bound below divides by ----
    fma_rate, fp32_peak, fma_entry = fma_phase(lib_path, build.find_nvcc(),
                                               card, dev)

    def bounds(ops, nbytes):
        """The kernels line's bound of ``ops`` f32 operations and ``nbytes``
        bytes: at the card's theoretical f32 rate (``bound_ms``,
        ``bound_by``) and at K3's measured rate (``bound_ms_measured``)."""
        b_ms, b_by = bound_ms(ops, nbytes, fp32_peak)
        return {"bound_ms": b_ms, "bound_by": b_by,
                "bound_ms_measured": bound_ms(ops, nbytes, fma_rate)[0]}

    def k2_floor(tab, tri_tab=None):
        """Per-segment f32 operations of K2's walk-independent floor."""
        return cluster_floor_per_segment(
            tab.n_global, tab.n_ss,
            *(() if tri_tab is None else (tri_tab.n_global, tri_tab.n_ss)))

    def floor_text(bnd):
        return (f"walk-independent floor {bnd['floor_ms']:.4f} ms (ray setup, "
                "globals and super-super slab tests per segment; the gate "
                "holds the kernel to the counted bound)")

    def bound_text(bnd):
        return (f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, at the "
                f"theoretical rate; {bnd['bound_ms_measured']:.4f} ms at K3's "
                "measured rate)")

    def walk_stats(visits, segs, k_ms):
        """What a K2 frame's walk visited (the counting instantiation's
        (n_tiles, 2, 7) counts): per segment, for path and shadow rays, the
        slab tests by level and the primitive tests; ns per visit (slab or
        primitive test) at the kernel's time; and the lanes a warp-issued
        primitive test carries on average (32: no divergence): sphere tests
        without a mesh, triangle tests with one (the warp column's)."""
        tot = visits.sum(dim=0).tolist()
        n = max(segs, 1)
        per = {kind: {c: v / n for c, v in zip(cluster_mod.VISIT_COLS, row)}
               for kind, row in zip(cluster_mod.VISIT_KINDS, tot)}
        tests = sum(sum(row[:6]) for row in tot)
        tris = sum(row[5] for row in tot)
        prims = tris if tris else sum(row[4] for row in tot)
        warps = sum(row[6] for row in tot)
        return {"visits_per_segment": per,
                "ns_per_visit": k_ms * 1e6 / max(tests, 1),
                "lanes_per_warp_test": prims / max(warps, 1)}

    def walk_text(w):
        def kind(k):
            v = w["visits_per_segment"][k]
            return (f"{k} slab {v['ss']:.2f}/{v['super']:.2f}/"
                    f"{v['cluster']:.2f}/{v['group']:.2f} (ss/super/cluster/"
                    f"group), spheres {v['sphere']:.2f}, triangles "
                    f"{v['tri']:.2f}")
        return (f"per segment {kind('path')}; {kind('shadow')}; "
                f"{w['ns_per_visit']:.4f} ns per visit; "
                f"{w['lanes_per_warp_test']:.1f} lanes per warp-issued "
                "primitive test")

    def k1_rays(visits, k_ms):
        """What a K1 frame's rays did (the counting instantiation's counts):
        path and shadow segments, the sphere and triangle tests per segment
        of each kind (a shadow ray's up to its first blocker), ns per test
        at the kernel's time, and the lanes a warp-issued test carries on
        average (32: no divergence)."""
        v = visits.sum(dim=0).tolist()
        per = {kind: {"segments": row[0], "sphere": row[1] / max(row[0], 1),
                      "tri": row[2] / max(row[0], 1)}
               for kind, row in zip(mk_mod.VISIT_KINDS, v)}
        tests = v[0][1] + v[0][2] + v[1][1] + v[1][2]
        return {"rays": per, "ns_per_test": k_ms * 1e6 / max(tests, 1),
                "lanes_per_warp_test": tests / max(v[0][3] + v[1][3], 1)}

    def k1_text(b):
        r = b["rays"]
        return (f"{r['path']['segments']} path segments "
                f"({r['path']['sphere']:.2f} sphere, {r['path']['tri']:.2f} "
                "triangle tests each), "
                f"{r['shadow']['segments']} shadow segments "
                f"({r['shadow']['sphere']:.2f} sphere, "
                f"{r['shadow']['tri']:.2f} triangle tests each, up to the "
                f"first blocker); {b['ns_per_test']:.5f} ns per test; "
                f"{b['lanes_per_warp_test']:.1f} lanes per warp-issued test")

    scene = tpu_rt_torch.demo_scene(device=dev)

    def cam_for(w, h, **pose):
        return tpu_rt_torch.make_camera(aspect=w / h, device=dev, **pose)

    # ---- 3. kernel vs the C++ depth-1 golden ----
    gold = np.load(GOLDENS / "ref_depth1_160x120.npy")
    img = render_megakernel(scene, cam_for(160, 120), 0, width=160,
                            height=120, spp=1, max_depth=1, jitter=False,
                            n_active=N_ACTIVE)
    d = np.abs(img.cpu().numpy() - gold).max(axis=-1)
    n_off = int((d > 1e-6).sum())
    print(f"[3 golden] {n_off} of {d.size} pixels beyond 1e-6 "
          f"(max abs {d.max():.3g})")
    check(n_off <= 2, "golden: at most 2 pixels may differ")

    # ---- 4. kernel vs plain on the card ----
    cam4 = cam_for(256, 128)
    for seed in (7, 2**31 - 2):
        kw = dict(width=256, height=128, spp=4, max_depth=4,
                  n_active=N_ACTIVE, with_stats=True)
        a, seg_a = render_megakernel(scene, cam4, seed, **kw)
        b, seg_b = render_megakernel_reference(scene, cam4, seed, **kw)
        stats = compare(a, b)
        print(f"[4 kernel vs plain] 256x128/4spp/d4 seed {seed}: {stats}, "
              f"segments {int(seg_a)} vs {int(seg_b)}")
        check_exact(stats, f"256x128 seed {seed}", (seg_a, seg_b))

    # ---- 5. main path ----
    rt = RayTracer(seed=0, device=dev)
    rt.set_scene(demo_api_scene())
    render_megakernel.launches = render_cluster.launches = 0
    acc, total, stack = None, 0, None
    for _ in range(4):
        batch = rt.render_device(INTERACTIVE["width"], INTERACTIVE["height"],
                                 INTERACTIVE["spp"], INTERACTIVE["max_depth"])
        acc, total = accumulate(acc, total, batch, INTERACTIVE["spp"])
        stack = display_stack(acc, EXPOSURE, as_uint8=True)
    torch.cuda.synchronize(dev)
    mega_launches = render_megakernel.launches
    print(f"[5 main path] RayTracer.render_device x4 at 640x480/8spp/d4 -> "
          f"accumulate -> display_stack: stack {tuple(stack.shape)} "
          f"{stack.dtype}; megakernel launches {mega_launches}, cluster "
          f"launches {render_cluster.launches}")
    check(mega_launches == 4, "the main path launched the megakernel 4 times")
    check(render_cluster.launches == 0, "the demo scene skips the cluster")
    check(tuple(stack.shape) == (2, 480, 640, 3), "stack shape")
    check(stack.dtype == torch.uint8, "uint8 stack")
    check(bool(torch.isfinite(acc).all()), "finite accumulator")
    check(int(stack.max()) - int(stack.min()) > 64, "nonblank image")
    # the same four batches through the plain version
    cam_main = rt.camera.to_params(dev)
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_megakernel_reference(
            scene, cam_main, batch_seed(0 + 1, f),  # RayTracer(seed=0)
            n_active=N_ACTIVE, **INTERACTIVE)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    stack_p = display_stack(acc_p, EXPOSURE, as_uint8=True)
    lsb = (stack.int() - stack_p.int()).abs()
    frac = float((lsb <= 1).float().mean())
    stats = compare(acc, acc_p)
    print(f"[5 main path] vs plain: accumulator {stats}; "
          f"uint8 within 1 LSB {frac:.6f}")
    check(frac >= 0.99, "main path vs plain: uint8 within 1 LSB for 99%")
    check_exact(stats, "main path accumulator")

    # ---- 6. statistics: RMSE of means falls as 1/sqrt(N) ----
    oracle = np.load(GOLDENS / "tpurt_v2lax_mean_64x48_512spp_d4_N4096.npy")
    cam48 = cam_for(64, 48)
    stride = 1 << 16

    def rmse_scaling(frame_fn, seeds, where):
        def mean_of(n, seed0):
            acc_m = torch.zeros((48, 64, 3), dtype=torch.float64, device=dev)
            for i in range(n):
                acc_m += frame_fn((seed0 + i) * stride)
            return (acc_m / n).float().cpu().numpy()

        r8 = float(np.sqrt(((mean_of(8, seeds[0]) - oracle) ** 2).mean()))
        r32 = float(np.sqrt(((mean_of(32, seeds[1]) - oracle) ** 2).mean()))
        print(f"[{where}] RMSE vs lax-v2 N=4096 mean: N=8 {r8:.6f}, "
              f"N=32 {r32:.6f}, ratio {r8 / r32:.3f}")
        check(r32 < r8 and 1.4 < r8 / r32 < 2.8 and r32 < 0.012,
              f"{where}: 1/sqrt(N) scaling")

    rmse_scaling(lambda seed: render_megakernel(
        scene, cam48, seed, width=64, height=48, spp=512, max_depth=4,
        n_active=N_ACTIVE), (9000, 9600), "6 statistics")

    # ---- 7. timing: kernel and plain, in turns ----
    mega = None
    for name, shape in (("640x480/8spp/d4", INTERACTIVE),
                        ("1080p/4spp/d4", BENCH)):
        cam_t = cam_for(shape["width"], shape["height"])
        kw = dict(n_active=N_ACTIVE, **shape)
        a, segs = render_megakernel(scene, cam_t, 1, with_stats=True, **kw)
        b, segs_b = render_megakernel_reference(scene, cam_t, 1,
                                                with_stats=True, **kw)
        stats = compare(a, b)
        check_exact(stats, name, (segs, segs_b))
        segs = int(segs)
        fns = {"kernel": lambda i: render_megakernel(scene, cam_t, 100 + i,
                                                     **kw),
               "plain": lambda i: render_megakernel_reference(
                   scene, cam_t, 100 + i, **kw)}
        times = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which] += cuda_frame_ms(fns[which], 7, device=dev)
        ms = {k: statistics.median(v) for k, v in times.items()}
        print(f"[7 timing] {name} on {card}: kernel {ms['kernel']:.4f} ms, "
              f"plain {ms['plain']:.4f} ms (median of 2x7 chained frames "
              f"each); {segs} segments/frame; traced Mrays/s kernel "
              f"{traced_mrays_per_s(segs, ms['kernel']):.1f}, plain "
              f"{traced_mrays_per_s(segs, ms['plain']):.1f}; kernel vs "
              f"plain {stats}")
        dev_ms = {}
        for which in ("kernel", "plain"):
            by_kernel = device_ms_by_kernel(fns[which], 5, device=dev)
            dev_ms[which] = kernel_ms(by_kernel, "megakernel")
            print("[7 device] " + device_line(f"{name} {which}", by_kernel,
                                              ms[which], "megakernel"))
        n_pix = shape["width"] * shape["height"]
        _, segs1, vis = render_megakernel(scene, cam_t, 1, with_stats=True,
                                          with_visits=True, **kw)
        ops = megakernel_op_model(int(segs1), n_pix, shape["spp"], N_ACTIVE,
                                  visits=vis)
        nbytes = megakernel_bytes(N_ACTIVE, n_pix)
        k_ms = dev_ms["kernel"]
        check(k_ms > 0, f"{name}: torch.profiler recorded the megakernel")
        bnd = dict(bounds(ops, nbytes), **k1_rays(vis, k_ms))
        ev_ms = event_kernel_ms(lib, "tpurt_megakernel_launch",
                                fns["kernel"], 20, dev)
        print(f"[7 bound] {name}: {ops / 1e9:.3f} G f32 ops, {nbytes} bytes "
              f"-> {bound_text(bnd)}; kernel {k_ms:.4f} ms "
              f"(profiler; CUDA events over 20 launches {ev_ms:.4f} ms), "
              f"{bnd['bound_ms'] / k_ms:.3f} of the bound's rate")
        print(f"[7 rays] {name}: {k1_text(bnd)}")
        if mega is None:  # the interactive shape is the main path's
            mega = {"name": "megakernel", "route": "cuda",
                    "source": "tpu_rt_torch/csrc/megakernel.cu",
                    "replaces": "tpu_rt/ops/pallas_megakernel.py:143",
                    "launches": mega_launches,
                    "max_abs_err": stats["max_abs"],
                    "ms": k_ms, "event_ms": ev_ms, "plain_ms": ms["plain"],
                    **bnd, "library_ms": None,
                    "shape": f"demo scene {name}", "plain_shape": name,
                    "frame_ms": ms["kernel"]}

    # ================= the cluster engine (more than 64 spheres) ===========
    # ---- 8. exactness: depth 1, pixel centres ----
    s200 = random_spheres(200, seed=3, device=dev)
    cam8 = cam_for(160, 96, position=(0, 3, 14), target=(0, 0, -6))
    kw = dict(width=160, height=96, spp=1, max_depth=1, jitter=False,
              n_active=200)
    a = render_cluster(s200, cam8, 0, **kw)
    b = render_cluster_reference(s200, cam8, 0, **kw)
    d = (a - b).abs().amax(dim=-1)
    n_off = int((d > 1e-6).sum())
    print(f"[8 cluster exact] random_spheres(200, seed=3) 160x96 depth 1, "
          f"pixel centres: {n_off} of {d.numel()} pixels beyond 1e-6 "
          f"(max abs {float(d.max()):.3g})")
    check_exact(compare(a, b), "cluster depth 1")

    # ---- 9. kernel vs plain on the 10k scene ----
    big = random_spheres(BIG["n"], seed=BIG["seed"], spread=BIG["spread"],
                         device=dev)
    cam9 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"], **BIG_CAM)
    cluster_err = 0.0
    for seed in (7, 2**31 - 2):
        kw = dict(n_active=BIG["n"], with_stats=True, **PLAIN_SHAPE)
        a, seg_a = render_cluster(big, cam9, seed, **kw)
        b, seg_b = render_cluster_reference(big, cam9, seed, **kw)
        stats = compare(a, b)
        cluster_err = max(cluster_err, stats["max_abs"])
        print(f"[9 cluster vs plain] 10k spheres 256x128/4spp/d4 seed "
              f"{seed}: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
        check_exact(stats, f"cluster 256x128 seed {seed}", (seg_a, seg_b))

    # ---- 10. main path on 10k spheres entered as Scene/Sphere objects ----
    host = random_spheres(BIG["n"], seed=BIG["seed"], spread=BIG["spread"],
                          device="cpu")
    api_scene = Scene()
    api_scene.background_color = Vector3(*host.background.tolist())
    for i in range(BIG["n"]):
        s = Sphere()
        s.center = Vector3(*host.center[i].tolist())
        s.radius = float(host.radius[i])
        m = Material()
        m.albedo = Vector3(*host.albedo[i].tolist())
        m.metallic = float(host.metallic[i])
        m.roughness = float(host.roughness[i])
        m.emission = Vector3(*host.emission[i].tolist())
        s.material = m
        s.object_id = i
        api_scene.add_sphere(s)
    rt = RayTracer(seed=5, device=dev)
    t0 = time.perf_counter()
    rt.set_scene(api_scene)
    torch.cuda.synchronize(dev)
    set_scene_s = time.perf_counter() - t0
    cam_api = rt.get_camera()
    cam_api.position, cam_api.target = (Vector3(*BIG_CAM["position"]),
                                        Vector3(*BIG_CAM["target"]))
    rt.set_camera(cam_api)
    render_megakernel.launches = render_cluster.launches = 0
    acc, total, stack = None, 0, None
    for _ in range(4):
        batch = rt.render_device(INTERACTIVE["width"], INTERACTIVE["height"],
                                 INTERACTIVE["spp"], INTERACTIVE["max_depth"])
        acc, total = accumulate(acc, total, batch, INTERACTIVE["spp"])
        stack = display_stack(acc, EXPOSURE, as_uint8=True)
    torch.cuda.synchronize(dev)
    cluster_launches = render_cluster.launches
    print(f"[10 cluster main path] RayTracer.set_scene(10k spheres) "
          f"{set_scene_s:.3f} s; render_device x4 at 640x480/8spp/d4 -> "
          f"accumulate -> display_stack: stack {tuple(stack.shape)} "
          f"{stack.dtype}; cluster launches {cluster_launches}, megakernel "
          f"launches {render_megakernel.launches}")
    check(cluster_launches == 4, "the main path launched the cluster 4 times")
    check(render_megakernel.launches == 0, "10k spheres skip the megakernel")
    check(tuple(stack.shape) == (2, 480, 640, 3), "stack shape")
    check(stack.dtype == torch.uint8, "uint8 stack")
    check(bool(torch.isfinite(acc).all()), "finite accumulator")
    check(int(stack.max()) - int(stack.min()) > 64, "nonblank image")
    cam_main = rt.camera.to_params(dev)
    # the plain chain builds its own tables from the tracer's snapshot
    tables = order_clusters(build_clusters(rt._scene_arrays,
                                           n_active=rt._n_active),
                            cam_main.position)
    acc_p, total_p = None, 0
    # the plain chain's batches, kept: phase 30's masked K2 chain runs on
    # the same scene, camera, tables and seeds, and the plain version
    # traces every block and zeroes the masked ones, so its masked batches
    # are these with the masked blocks zeroed (run once, shared)
    plain10 = []
    for f in range(4):
        b = render_cluster_reference(
            None, cam_main, batch_seed(5 + 1, f), prebuilt=tables,
            pre_ordered=True, **INTERACTIVE)
        plain10.append(b)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    scene10, cam10, tables10 = rt._scene_arrays, cam_main, tables
    stack_p = display_stack(acc_p, EXPOSURE, as_uint8=True)
    lsb = (stack.int() - stack_p.int()).abs()
    frac = float((lsb <= 1).float().mean())
    stats = compare(acc, acc_p)
    print(f"[10 cluster main path] vs plain: accumulator {stats}; uint8 "
          f"within 1 LSB {frac:.6f}")
    check(frac >= 0.99, "cluster main path vs plain: 99% within 1 LSB")
    check_exact(stats, "cluster main path accumulator")

    # ---- 11. statistics: the demo scene through the cluster engine ----
    pre9 = order_clusters(build_clusters(scene, n_active=9), cam48.position)
    rmse_scaling(lambda seed: render(
        scene, cam48, seed, width=64, height=48, spp=512, max_depth=4,
        engine="cluster", prebuilt=pre9, pre_ordered=True),
        (11000, 11600), "11 cluster statistics")

    # ---- 12. timing ----
    def cluster_timing(label, fn, seg_fn, n_pix, spp, tables_):
        """Frame ms over chained frames, cluster device ms, idle share,
        segments/frame and traced Mrays/s of ``fn``; ``seg_fn()`` gives
        (segments, visit counts) from the counting instantiation, which the
        bound counts (utils/roofline.py:cluster_op_model). Returns the
        kernel's device ms, CUDA-event ms, frame ms and bound (with the
        walk's visits)."""
        frame = statistics.median(cuda_frame_ms(fn, 7, device=dev)
                                  + cuda_frame_ms(fn, 7, device=dev))
        by_kernel = device_ms_by_kernel(fn, 5, device=dev)
        k_ms = kernel_ms(by_kernel, "cluster_kernel")
        check(k_ms > 0, f"{label}: torch.profiler recorded the cluster kernel")
        ev_ms = event_kernel_ms(lib, "tpurt_cluster_launch", fn, 20, dev)
        segs, visits = seg_fn()
        segs = int(segs)
        ops = cluster_op_model(segs, visits, n_pix, spp)
        nbytes = (sum(t.numel() * t.element_size() for t in tables_)
                  + 16 * 4 + n_pix * 12)
        bnd = dict(bounds(ops, nbytes), **walk_stats(visits, segs, k_ms))
        bnd["floor_ms"] = bound_ms(path_ops(segs, n_pix, spp,
                                            k2_floor(tables_)),
                                   nbytes, fp32_peak)[0]
        print(f"[12 timing] {label} on {card}: frame {frame:.4f} ms (median "
              f"of 2x7 chained frames), cluster kernel {k_ms:.4f} ms "
              f"(profiler; CUDA events over 20 launches {ev_ms:.4f} ms); "
              f"{segs} segments/frame; traced Mrays/s frame "
              f"{traced_mrays_per_s(segs, frame):.1f}, kernel "
              f"{traced_mrays_per_s(segs, k_ms):.1f}; {bound_text(bnd)} "
              f"({ops / 1e9:.3f} G f32 ops, the walk counted), "
              f"{bnd['bound_ms'] / k_ms:.4f} of the bound's rate; "
              f"{floor_text(bnd)}")
        print(f"[12 walk] {label}: {walk_text(bnd)}")
        print("[12 device] " + device_line(label, by_kernel, frame,
                                           "cluster_kernel"))
        return k_ms, ev_ms, frame, bnd

    # (a) the JAX bench's large-scene row, tables built and ordered once
    cam_a = cam_for(BENCH["width"], BENCH["height"], **BIG_CAM)
    tab_a = order_clusters(build_clusters(big, n_active=BIG["n"]),
                           cam_a.position)
    kw_a = dict(prebuilt=tab_a, pre_ordered=True, **BENCH)
    cluster_timing(
        "(a) 10k spheres 1080p/4spp/d4",
        lambda i: render_cluster(None, cam_a, 200 + i, **kw_a),
        lambda: render_cluster(None, cam_a, 0, with_stats=True,
                               with_visits=True, **kw_a)[1:],
        BENCH["width"] * BENCH["height"], BENCH["spp"], tab_a)
    # (b) the main path at the GUI's settings
    tab_b = tables
    k_b, ev_b, frame_b, bnd_b = cluster_timing(
        "(b) RayTracer 10k spheres 640x480/8spp/d4",
        lambda i: rt.render_device(INTERACTIVE["width"],
                                   INTERACTIVE["height"], INTERACTIVE["spp"],
                                   INTERACTIVE["max_depth"]),
        lambda: render_cluster(None, rt.camera.to_params(dev), 0,
                               prebuilt=tab_b, pre_ordered=True,
                               with_stats=True, with_visits=True,
                               **INTERACTIVE)[1:],
        INTERACTIVE["width"] * INTERACTIVE["height"], INTERACTIVE["spp"],
        tab_b)
    # (c) 100k spheres, kernel only
    huge = random_spheres(HUGE["n"], seed=HUGE["seed"],
                          spread=HUGE["spread"], device=dev)
    tab_c = order_clusters(build_clusters(huge, n_active=HUGE["n"]),
                           cam_a.position)
    print(f"[12 timing] (c) 100k spheres: K {tab_c.n_clusters}, S "
          f"{tab_c.n_supers}, S2 {tab_c.n_ss}, attr "
          f"{tab_c.attr.numel() * 4 / 1e6:.2f} MB")
    kw_c = dict(prebuilt=tab_c, pre_ordered=True, **BENCH)
    cluster_timing(
        "(c) 100k spheres 1080p/4spp/d4",
        lambda i: render_cluster(None, cam_a, 300 + i, **kw_c),
        lambda: render_cluster(None, cam_a, 0, with_stats=True,
                               with_visits=True, **kw_c)[1:],
        BENCH["width"] * BENCH["height"], BENCH["spp"], tab_c)
    # the plain version, at 256x128 only: its sweep is O(N) per ray
    tab_p = order_clusters(build_clusters(big, n_active=BIG["n"]),
                           cam9.position)
    kw_p = dict(prebuilt=tab_p, pre_ordered=True, **PLAIN_SHAPE)
    fns = {"kernel": lambda i: render_cluster(None, cam9, 400 + i, **kw_p),
           "plain": lambda i: render_cluster_reference(None, cam9, 400 + i,
                                                       **kw_p)}
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which] += cuda_frame_ms(fns[which], 3, device=dev)
    ms_p = {k: statistics.median(v) for k, v in times.items()}
    print(f"[12 timing] 10k spheres 256x128/4spp/d4 (the plain version's "
          f"shape: its brute-force sweep is O(N) per ray and would not "
          f"finish the full sizes in this script's time): kernel "
          f"{ms_p['kernel']:.4f} ms, plain {ms_p['plain']:.4f} ms (median "
          f"of 2x3 chained frames each, in turns)")

    cluster = {"name": "cluster-spheres", "route": "cuda",
               "source": "tpu_rt_torch/csrc/cluster.cu",
               "replaces": "tpu_rt/ops/pallas_cluster.py:567",
               "launches": cluster_launches, "max_abs_err": cluster_err,
               "ms": k_b, "event_ms": ev_b, "plain_ms": ms_p["plain"],
               **bnd_b, "library_ms": None,
               "shape": "RayTracer 10k spheres 640x480/8spp/d4",
               "frame_ms": frame_b, "plain_shape": "10k spheres "
               "256x128/4spp/d4", "frame_ms_at_plain_shape": ms_p["kernel"]}

    # ================= triangle meshes =====================================
    from tpu_rt_torch.app import run as app_run
    from tpu_rt_torch.core.scenes import cornell_box, terrain_mesh
    from tpu_rt_torch.ops.cluster import build_tri_clusters
    from tpu_rt_torch.utils.objio import load_obj, save_obj

    cs, cm = cornell_box(device=dev)

    def cornell_cam(w, h):
        return cam_for(w, h, **CORNELL_CAM)

    # ---- 13. K1-tri exactness: the Cornell box through the megakernel ----
    cam13 = cornell_cam(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"])
    mesh_err = 0.0
    for label, kw in (
            ("256x128/4spp/d4 seed 7", dict(seed=7, **PLAIN_SHAPE)),
            ("256x128/4spp/d4 seed 2^31-2", dict(seed=2**31 - 2,
                                                 **PLAIN_SHAPE)),
            ("256x128 depth 1, pixel centres", dict(
                seed=0, width=256, height=128, spp=1, max_depth=1,
                jitter=False))):
        seed = kw.pop("seed")
        kw.update(mesh=cm, with_stats=True, **CORNELL_ACTIVE)
        a, seg_a = render_megakernel(cs, cam13, seed, **kw)
        b, seg_b = render_megakernel_reference(cs, cam13, seed, **kw)
        stats = compare(a, b)
        mesh_err = max(mesh_err, stats["max_abs"])
        print(f"[13 K1-tri vs plain] Cornell box {label}: {stats}, "
              f"segments {int(seg_a)} vs {int(seg_b)}")
        check_exact(stats, f"K1-tri {label}", (seg_a, seg_b))
        check(float(a.max()) > 0, "K1-tri: nonblank image")

    # ---- 14. K2-tri exactness: 10k terrain triangles, and the Cornell box
    # through the cluster engine ----
    ts, tm = terrain_mesh(n=TERRAIN_10K, seed=1, device=dev)
    check(int(tm.valid.sum()) == 10082, "terrain n=72 has 10,082 triangles")
    cam14 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"], **TERRAIN_CAM)
    cluster_tri_err = 0.0
    for seed in (7, 2**31 - 2):
        kw = dict(mesh=tm, with_stats=True, **PLAIN_SHAPE)
        a, seg_a = render_cluster(ts, cam14, seed, **kw)
        b, seg_b = render_cluster_reference(ts, cam14, seed, **kw)
        stats = compare(a, b)
        cluster_tri_err = max(cluster_tri_err, stats["max_abs"])
        print(f"[14 K2-tri vs plain] terrain 10k 256x128/4spp/d4 seed "
              f"{seed}: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
        check_exact(stats, f"K2-tri terrain seed {seed}", (seg_a, seg_b))
    kw = dict(mesh=cm, with_stats=True, engine="cluster", **PLAIN_SHAPE)
    before = render_cluster.launches
    a, seg_a = render(cs, cam13, 7, **kw)
    check(render_cluster.launches == before + 1,
          "engine='cluster' with a mesh launched the cluster kernel")
    b, seg_b = render_cluster_reference(cs, cam13, 7, mesh=cm,
                                        with_stats=True, **PLAIN_SHAPE)
    stats = compare(a, b)
    cluster_tri_err = max(cluster_tri_err, stats["max_abs"])
    print(f"[14 K2-tri vs plain] Cornell box through engine='cluster' "
          f"256x128/4spp/d4: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
    check_exact(stats, "K2-tri Cornell", (seg_a, seg_b))

    # ---- 15. main path with a mesh ----
    def api_scene_of(spheres):
        sc = Scene()
        sc.background_color = Vector3(*spheres.background.tolist())
        for i in range(int(spheres.valid.sum())):
            sp = Sphere()
            sp.center = Vector3(*spheres.center[i].tolist())
            sp.radius = float(spheres.radius[i])
            mat = Material()
            mat.albedo = Vector3(*spheres.albedo[i].tolist())
            mat.metallic = float(spheres.metallic[i])
            mat.roughness = float(spheres.roughness[i])
            mat.emission = Vector3(*spheres.emission[i].tolist())
            sp.material = mat
            sp.object_id = i
            sc.add_sphere(sp)
        return sc

    def aim(rt_, pose):
        c = rt_.get_camera()
        c.position, c.target = (Vector3(*pose["position"]),
                                Vector3(*pose["target"]))
        rt_.set_camera(c)

    def main_path(rt_):
        acc_, total_, stack_ = None, 0, None
        for _ in range(4):
            batch_ = rt_.render_device(
                INTERACTIVE["width"], INTERACTIVE["height"],
                INTERACTIVE["spp"], INTERACTIVE["max_depth"])
            acc_, total_ = accumulate(acc_, total_, batch_, INTERACTIVE["spp"])
            stack_ = display_stack(acc_, EXPOSURE, as_uint8=True)
        torch.cuda.synchronize(dev)
        return acc_, stack_

    def check_stack(stack_, acc_, what):
        check(tuple(stack_.shape) == (2, 480, 640, 3), f"{what}: stack shape")
        check(stack_.dtype == torch.uint8, f"{what}: uint8 stack")
        check(bool(torch.isfinite(acc_).all()), f"{what}: finite accumulator")
        check(int(stack_.max()) - int(stack_.min()) > 64,
              f"{what}: nonblank image")

    # (a) terrain: 3 spheres + 10k triangles -> the cluster engine; count
    # the table builds and orderings of set_mesh and the four batches
    calls = {}
    originals = {}
    for fname in ("build_clusters", "build_tri_clusters", "order_clusters"):
        originals[fname] = getattr(cluster_mod, fname)

        def counted(*a, _f=originals[fname], _n=fname, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        setattr(cluster_mod, fname, counted)
    rt_t = RayTracer(seed=7, device=dev)
    rt_t.set_scene(api_scene_of(ts))
    rt_t.set_mesh(tm)
    aim(rt_t, TERRAIN_CAM)
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_t)
    tri_launches = render_cluster.launches
    mega_in_terrain = render_megakernel.launches
    for fname, fn in originals.items():
        setattr(cluster_mod, fname, fn)
    print(f"[15 mesh main path] RayTracer.set_scene(3 spheres) + "
          f"set_mesh(terrain, 10,082 triangles); render_device x4 at "
          f"640x480/8spp/d4 -> accumulate -> display_stack: stack "
          f"{tuple(stack.shape)} {stack.dtype}; cluster launches "
          f"{tri_launches}, megakernel launches {mega_in_terrain}; table "
          f"builds and orderings {calls}")
    check(tri_launches == 4, "the mesh main path launched the cluster 4 times")
    check(mega_in_terrain == 0, "a 10k-triangle mesh skips the megakernel")
    check(calls == {"build_clusters": 1, "build_tri_clusters": 1,
                    "order_clusters": 2},
          "tables built once and ordered once (spheres and triangles)")
    check_stack(stack, acc, "mesh main path")
    # the same chain through the plain version, at full size
    cam_t = rt_t.camera.to_params(dev)
    t_tables = order_clusters(build_clusters(rt_t._scene_arrays,
                                             n_active=rt_t._n_active),
                              cam_t.position)
    t_tri = order_clusters(build_tri_clusters(tm,
                                              n_active=rt_t._n_tri_active),
                           cam_t.position)
    t0 = time.perf_counter()
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_cluster_reference(
            None, cam_t, batch_seed(7 + 1, f), prebuilt=t_tables,
            tri_prebuilt=t_tri, pre_ordered=True, **INTERACTIVE)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    torch.cuda.synchronize(dev)
    stats = compare(acc, acc_p)
    cluster_tri_err = max(cluster_tri_err, stats["max_abs"])
    print(f"[15 mesh main path] vs the plain chain at the same size "
          f"(640x480/8spp/d4, {time.perf_counter() - t0:.1f} s): "
          f"accumulator {stats}")
    check_exact(stats, "mesh main path accumulator")

    # (b) the Cornell box through RayTracer -> the megakernel
    rt_c = RayTracer(seed=9, device=dev)
    rt_c.set_scene(api_scene_of(cs))
    rt_c.set_mesh(cm)
    aim(rt_c, CORNELL_CAM)
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_c)
    mega_tri_launches = render_megakernel.launches
    print(f"[15 mesh main path] RayTracer + set_mesh(Cornell box, 12 "
          f"triangles) x4 at 640x480/8spp/d4: megakernel launches "
          f"{mega_tri_launches}, cluster launches {render_cluster.launches}")
    check(mega_tri_launches == 4, "the Cornell box launched the megakernel 4x")
    check(render_cluster.launches == 0, "the Cornell box skips the cluster")
    check_stack(stack, acc, "Cornell main path")
    cam_c = rt_c.camera.to_params(dev)
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_megakernel_reference(
            rt_c._scene_arrays, cam_c, batch_seed(9 + 1, f), mesh=cm,
            **CORNELL_ACTIVE, **INTERACTIVE)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    stats = compare(acc, acc_p)
    mesh_err = max(mesh_err, stats["max_abs"])
    print(f"[15 mesh main path] Cornell vs the plain chain: accumulator "
          f"{stats}")
    check_exact(stats, "Cornell main path accumulator")

    # (c) an OBJ file the script writes, through the headless app's --obj
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "cornell.obj"
        save_obj(str(obj), cm)
        back = load_obj(str(obj), device=dev)
        check(int(back.valid.sum()) == 12 and bool(torch.equal(
            back.v0[:12], cm.v0[:12])), "load_obj(save_obj(Cornell))")
        png = Path(tmp) / "obj.png"
        render_megakernel.launches = 0
        rc = app_run.main(["--headless", "--device", "cuda", "--width", "160",
                           "--height", "120", "--samples", "8", "--batch",
                           "8", "--depth", "4", "--obj", str(obj),
                           "--output", str(png)])
        check(rc == 0 and (png.exists() or png.with_suffix(".png.npy")
                           .exists()), "app --obj wrote its image")
        check(render_megakernel.launches == 1,
              "app --obj: demo scene + 12 triangles, one megakernel batch")
    print(f"[15 mesh main path] OBJ: save_obj(Cornell) -> load_obj -> "
          f"python -m tpu_rt_torch.app.run --headless --obj: rc {rc}, "
          f"megakernel launches {render_megakernel.launches}")

    # ---- 16. statistics: Cornell means against a high-N kernel mean ----
    cam16 = cornell_cam(64, 48)

    def cornell_mean(n, seed0):
        acc_m = torch.zeros((48, 64, 3), dtype=torch.float64, device=dev)
        for i in range(n):
            acc_m += render_megakernel(cs, cam16, (seed0 + i) * (1 << 16),
                                       width=64, height=48, spp=64,
                                       max_depth=4, mesh=cm, **CORNELL_ACTIVE)
        return acc_m / n

    ref_mean = cornell_mean(512, 40000)
    r8 = float(torch.sqrt(((cornell_mean(8, 50000) - ref_mean) ** 2).mean()))
    r32 = float(torch.sqrt(((cornell_mean(32, 51000) - ref_mean) ** 2)
                           .mean()))
    print(f"[16 mesh statistics] Cornell 64x48/64spp/d4: RMSE vs the N=512 "
          f"kernel mean: N=8 {r8:.6f}, N=32 {r32:.6f}, ratio {r8 / r32:.3f} "
          f"(1/sqrt(N) with the reference's own noise predicts 1.955)")
    check(r32 < r8 and 1.4 < r8 / r32 < 2.8, "Cornell 1/sqrt(N) scaling")

    # ---- 17. timing ----
    def mesh_timing(label, fn, seg_fn, n_pix, spp, kname, per_segment,
                    nbytes, flags=None, phase=17):
        """Frame ms, kernel device ms, idle share, segments/frame, traced
        Mrays/s and the bound of ``fn``; returns (kernel ms (profiler),
        kernel ms (CUDA events), frame ms, :func:`bounds`). ``seg_fn()``
        gives (segments, visit counts) from the counting instantiation. For
        the cluster kernel the bound counts the walk (cluster_op_model) and
        ``per_segment`` gives the walk-independent floor beside it
        (``floor_ms``); for the megakernel ``per_segment`` is the
        (spheres, triangles) a path segment sweeps and the bound is
        megakernel_op_model's, the shadow sweep counted."""
        frame = statistics.median(cuda_frame_ms(fn, 7, device=dev)
                                  + cuda_frame_ms(fn, 7, device=dev))
        by_kernel = device_ms_by_kernel(fn, 5, device=dev)
        k_ms = kernel_ms(by_kernel, kname)
        check(k_ms > 0, f"{label}: torch.profiler recorded {kname}")
        entry = ("tpurt_cluster_launch" if kname == "cluster_kernel"
                 else "tpurt_megakernel_launch")
        ev_ms = event_kernel_ms(lib, entry, fn, 20, dev)
        segs, visits = seg_fn()
        segs = int(segs)
        if kname == "cluster_kernel":
            ops = cluster_op_model(segs, visits, n_pix, spp, flags)
            bnd = dict(bounds(ops, nbytes + n_pix * 12),
                       **walk_stats(visits, segs, k_ms))
            bnd["floor_ms"] = bound_ms(
                path_ops(segs, n_pix, spp, per_segment, flags),
                nbytes + n_pix * 12, fp32_peak)[0]
        else:
            n_sph, n_tri = per_segment
            ops = megakernel_op_model(segs, n_pix, spp, n_sph, n_tris=n_tri,
                                      flags=flags, visits=visits)
            bnd = dict(bounds(ops, nbytes + n_pix * 12),
                       **k1_rays(visits, k_ms))
        print(f"[{phase} timing] {label} on {card}: frame {frame:.4f} ms "
              f"(median "
              f"of 2x7 chained frames), {kname} {k_ms:.4f} ms (profiler; "
              f"CUDA events over 20 launches {ev_ms:.4f} ms); {segs} "
              f"segments/frame; traced Mrays/s frame "
              f"{traced_mrays_per_s(segs, frame):.1f}, kernel "
              f"{traced_mrays_per_s(segs, k_ms):.1f}; {bound_text(bnd)} "
              f"({ops / 1e9:.3f} G f32 ops), {bnd['bound_ms'] / k_ms:.4f} of "
              "the bound's rate")
        if "visits_per_segment" in bnd:
            print(f"[{phase} walk] {label}: {walk_text(bnd)}; "
                  f"{floor_text(bnd)}")
        else:
            print(f"[{phase} rays] {label}: {k1_text(bnd)}")
        print(f"[{phase} device] " + device_line(label, by_kernel, frame,
                                                 kname))
        return k_ms, ev_ms, frame, bnd

    def table_bytes(*tables):
        return sum(t.numel() * t.element_size() for tab in tables
                   for t in tab)

    # K1-tri: per segment 4 sphere tests and 12 Moller-Trumbore tests
    k1_tri_prims = (CORNELL_ACTIVE["n_active"],
                    CORNELL_ACTIVE["n_tri_active"])
    k1_tri_bytes = (4 * 16 + 12 * 20 + 16 + 3) * 4
    mega_tri = None
    for name, shape in (("640x480/8spp/d4", INTERACTIVE),
                        ("1080p/4spp/d4", BENCH)):
        cam_t = cornell_cam(shape["width"], shape["height"])
        kw = dict(mesh=cm, **CORNELL_ACTIVE, **shape)
        k_ms, ev_ms, frame, bnd = mesh_timing(
            f"K1-tri Cornell {name}",
            lambda i: render_megakernel(cs, cam_t, 500 + i, **kw),
            lambda: render_megakernel(cs, cam_t, 0, with_stats=True,
                                      with_visits=True, **kw)[1:],
            shape["width"] * shape["height"], shape["spp"], "megakernel",
            k1_tri_prims, k1_tri_bytes + (-(-shape["width"] * shape["height"]
                                          // 4096)) * 4)
        if mega_tri is None:  # the Cornell main path's shape
            times = {"kernel": [], "plain": []}
            fns = {"kernel": lambda i: render_megakernel(cs, cam_t, 600 + i,
                                                         **kw),
                   "plain": lambda i: render_megakernel_reference(
                       cs, cam_t, 600 + i, **kw)}
            for which in ("plain", "kernel", "kernel", "plain"):
                times[which] += cuda_frame_ms(fns[which], 3, device=dev)
            mp = {k: statistics.median(v) for k, v in times.items()}
            print(f"[17 timing] K1-tri Cornell {name}: kernel frame "
                  f"{mp['kernel']:.4f} ms, plain {mp['plain']:.4f} ms (median "
                  f"of 2x3 chained frames each, in turns)")
            mega_tri = {"name": "megakernel-triangles", "route": "cuda",
                        "source": "tpu_rt_torch/csrc/megakernel.cu",
                        "replaces": "tpu_rt/ops/pallas_megakernel.py:345",
                        "launches": mega_tri_launches,
                        "max_abs_err": mesh_err, "ms": k_ms,
                        "event_ms": ev_ms,
                        "plain_ms": mp["plain"], **bnd,
                        "library_ms": None,
                        "shape": f"Cornell box (4 sphere rows, 12 "
                                 f"triangles) {name}",
                        "plain_shape": name, "frame_ms": frame}

    cam_b = cam_for(BENCH["width"], BENCH["height"], **TERRAIN_CAM)
    for label, n in (("10k", TERRAIN_10K), ("100k", TERRAIN_100K)):
        sp_n, m_n = (ts, tm) if n == TERRAIN_10K else terrain_mesh(
            n=n, seed=1, device=dev)
        tab = order_clusters(build_clusters(sp_n, n_active=3), cam_b.position)
        tri_tab = order_clusters(build_tri_clusters(m_n), cam_b.position)
        print(f"[17 timing] terrain {label}: {int(m_n.valid.sum())} "
              f"triangles, K {tri_tab.n_clusters}, S {tri_tab.n_supers}, S2 "
              f"{tri_tab.n_ss}, attr {tri_tab.attr.numel() * 4 / 1e6:.2f} MB")
        kw = dict(prebuilt=tab, tri_prebuilt=tri_tab, pre_ordered=True,
                  **BENCH)
        mesh_timing(
            f"K2-tri terrain {label} 1080p/4spp/d4",
            lambda i: render_cluster(None, cam_b, 700 + i, **kw),
            lambda: render_cluster(None, cam_b, 0, with_stats=True,
                                   with_visits=True, **kw)[1:],
            BENCH["width"] * BENCH["height"], BENCH["spp"], "cluster_kernel",
            k2_floor(tab, tri_tab), table_bytes(tab, tri_tab) + 16 * 4)
    # the terrain main path (RayTracer + set_mesh) at the GUI's settings
    k_tri, ev_tri, frame_tri, bnd_tri = mesh_timing(
        "K2-tri RayTracer + terrain 10k 640x480/8spp/d4",
        lambda i: rt_t.render_device(INTERACTIVE["width"],
                                     INTERACTIVE["height"],
                                     INTERACTIVE["spp"],
                                     INTERACTIVE["max_depth"]),
        lambda: render_cluster(None, rt_t.camera.to_params(dev), 0,
                               prebuilt=t_tables, tri_prebuilt=t_tri,
                               pre_ordered=True, with_stats=True,
                               with_visits=True, **INTERACTIVE)[1:],
        INTERACTIVE["width"] * INTERACTIVE["height"], INTERACTIVE["spp"],
        "cluster_kernel", k2_floor(t_tables, t_tri),
        table_bytes(t_tables, t_tri) + 16 * 4)
    # the plain version at 256x128 only: its sweep is O(N) per ray
    tab_p = order_clusters(build_clusters(ts, n_active=3), cam14.position)
    tri_p = order_clusters(build_tri_clusters(tm), cam14.position)
    kw_p = dict(prebuilt=tab_p, tri_prebuilt=tri_p, pre_ordered=True,
                **PLAIN_SHAPE)
    fns = {"kernel": lambda i: render_cluster(None, cam14, 800 + i, **kw_p),
           "plain": lambda i: render_cluster_reference(None, cam14, 800 + i,
                                                       **kw_p)}
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which] += cuda_frame_ms(fns[which], 3, device=dev)
    ms_tp = {k: statistics.median(v) for k, v in times.items()}
    print(f"[17 timing] terrain 10k 256x128/4spp/d4 (the plain version's "
          f"shape): kernel {ms_tp['kernel']:.4f} ms, plain "
          f"{ms_tp['plain']:.4f} ms (median of 2x3 chained frames each, in "
          f"turns)")
    cluster_tri = {"name": "cluster-triangles", "route": "cuda",
                   "source": "tpu_rt_torch/csrc/cluster.cu",
                   "replaces": "tpu_rt/ops/pallas_cluster.py:868",
                   "launches": tri_launches, "max_abs_err": cluster_tri_err,
                   "ms": k_tri, "event_ms": ev_tri,
                   "plain_ms": ms_tp["plain"],
                   **bnd_tri, "library_ms": None,
                   "shape": "RayTracer 3 spheres + terrain 10k triangles "
                            "640x480/8spp/d4",
                   "frame_ms": frame_tri,
                   "plain_shape": "terrain 10k 256x128/4spp/d4",
                   "frame_ms_at_plain_shape": ms_tp["kernel"]}

    # ================= refraction, thin lens, R2 stratify =================
    from tpu_rt_torch.ops.triangle import box, merge_meshes
    from tpu_rt_torch.render.frame import quantize_count

    # the Cornell box with a glass box on its floor: 24 triangles
    glass_box = box(center=(-0.2, 0.36, -1.9), size=(0.7, 0.7, 0.7),
                    device=dev, **GLASS)
    gcm = merge_meshes([cm, glass_box])
    glass_cornell = dict(mesh=gcm, n_active=4, n_tri_active=24)

    # ---- 18. K1 flags: kernel vs plain, bit for bit ----
    cam18 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"], aperture=0.1)
    cam18c = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"],
                     aperture=0.1, **CORNELL_CAM)
    mega_flags_err = 0.0
    cases = [(f"demo scene {k}", scene, cam18, dict(n_active=N_ACTIVE), f)
             for k, f in FLAG_SETS.items()]
    cases.append(("glass Cornell box all three", cs, cam18c, glass_cornell,
                  ALL_FLAGS))
    for label, sc, cam_, kw_s, flags in cases:
        for seed in (7, 2**31 - 2):
            kw = dict(with_stats=True, **kw_s, **PLAIN_SHAPE, **flags)
            a, seg_a = render_megakernel(sc, cam_, seed, **kw)
            b, seg_b = render_megakernel_reference(sc, cam_, seed, **kw)
            stats = compare(a, b)
            mega_flags_err = max(mega_flags_err, stats["max_abs"])
            print(f"[18 K1 flags vs plain] {label} 256x128/4spp/d4 seed "
                  f"{seed}: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K1 {label} seed {seed}", (seg_a, seg_b))
    plain_img = render_megakernel(scene, cam18, 7, n_active=N_ACTIVE,
                                  **PLAIN_SHAPE)
    flags_img = render_megakernel(scene, cam18, 7, n_active=N_ACTIVE,
                                  **PLAIN_SHAPE, **ALL_FLAGS)
    check(not torch.equal(plain_img, flags_img), "K1: the flags change it")

    # ---- 19. K2 flags: kernel vs plain on a 10k glass field, and the
    # terrain with refraction + DOF through engine="cluster" ----
    field = glass_field(big)
    n_glass = int(((field.roughness == 0) & (field.ior == 1.5)
                   & field.valid).sum())
    cam19 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"],
                    aperture=0.2, **FIELD_CAM)
    tab19 = order_clusters(build_clusters(field, n_active=BIG["n"]),
                           cam19.position)
    cluster_flags_err = 0.0
    for label, flags in FLAG_SETS.items():
        for seed in (7, 2**31 - 2):
            kw = dict(prebuilt=tab19, pre_ordered=True, with_stats=True,
                      **PLAIN_SHAPE, **flags)
            a, seg_a = render_cluster(None, cam19, seed, **kw)
            b, seg_b = render_cluster_reference(None, cam19, seed, **kw)
            stats = compare(a, b)
            cluster_flags_err = max(cluster_flags_err, stats["max_abs"])
            print(f"[19 K2 flags vs plain] glass field (10k spheres, "
                  f"{n_glass} glass) {label} 256x128/4spp/d4 seed {seed}: "
                  f"{stats}, segments {int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K2 glass field {label} seed {seed}",
                        (seg_a, seg_b))
    cam19t = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"],
                     aperture=0.2, **TERRAIN_CAM)
    before = render_cluster.launches
    # enable_dof is left to render(): the camera's aperture switches it on
    a, seg_a = render(ts, cam19t, 7, mesh=tm, engine="cluster",
                      with_stats=True, enable_refraction=True, **PLAIN_SHAPE)
    check(render_cluster.launches == before + 1,
          "terrain with flags: engine='cluster' launched the cluster kernel")
    b, seg_b = render_cluster_reference(
        ts, cam19t, 7, mesh=tm, with_stats=True, enable_refraction=True,
        enable_dof=True, n_active=quantize_count(3, ts.capacity),
        n_tri_active=quantize_count(int(tm.valid.sum()), tm.capacity),
        **PLAIN_SHAPE)
    stats = compare(a, b)
    cluster_flags_err = max(cluster_flags_err, stats["max_abs"])
    print(f"[19 K2 flags vs plain] terrain 10k refraction + DOF "
          f"256x128/4spp/d4 through engine='cluster': {stats}, segments "
          f"{int(seg_a)} vs {int(seg_b)}")
    check_exact(stats, "K2 terrain refraction + DOF", (seg_a, seg_b))

    # ---- 20. main paths with the flags ----
    def lens_and_strata(rt_, aperture):
        c = rt_.get_camera()
        c.aperture = aperture
        rt_.set_camera(c)
        rt_.set_stratify(True)

    # (a) the demo scene: RayTracer(enable_refraction=True), aperture 0.1,
    # set_stratify(True) -> the megakernel
    rt_f = RayTracer(11, "v2", True, device=dev)
    rt_f.set_scene(demo_api_scene())
    lens_and_strata(rt_f, 0.1)
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_f)
    flags_launches = render_megakernel.launches
    print(f"[20 flags main path] RayTracer(enable_refraction=True) + "
          f"aperture 0.1 + set_stratify(True), demo scene, x4 at "
          f"640x480/8spp/d4: megakernel launches {flags_launches}, cluster "
          f"launches {render_cluster.launches}")
    check(flags_launches == 4, "the flags main path launched the megakernel "
          "4 times")
    check(render_cluster.launches == 0, "the demo scene skips the cluster")
    check_stack(stack, acc, "flags main path")
    cam_f = rt_f.camera.to_params(dev)
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_megakernel_reference(
            rt_f._scene_arrays, cam_f, batch_seed(11 + 1, f),
            n_active=N_ACTIVE, **INTERACTIVE, **ALL_FLAGS)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    stats = compare(acc, acc_p)
    mega_flags_err = max(mega_flags_err, stats["max_abs"])
    print(f"[20 flags main path] vs the plain chain: accumulator {stats}")
    check_exact(stats, "flags main path accumulator")

    # (b) the glass field as Scene objects, same settings -> the cluster
    field_host = glass_field(random_spheres(
        BIG["n"], seed=BIG["seed"], spread=BIG["spread"], device="cpu"))
    rt_g = RayTracer(13, "v2", True, device=dev)
    rt_g.set_scene(api_scene_of(field_host))
    aim(rt_g, FIELD_CAM)
    lens_and_strata(rt_g, 0.1)
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_g)
    glass_launches = render_cluster.launches
    print(f"[20 flags main path] RayTracer(enable_refraction=True) + "
          f"aperture 0.1 + set_stratify(True), glass field (10k Scene "
          f"objects) x4 at 640x480/8spp/d4: cluster launches "
          f"{glass_launches}, megakernel launches "
          f"{render_megakernel.launches}")
    check(glass_launches == 4, "the glass field launched the cluster 4 times")
    check(render_megakernel.launches == 0, "the glass field skips K1")
    check_stack(stack, acc, "glass field main path")
    # the same four batches through the plain version, at full size
    cam_g = rt_g.camera.to_params(dev)
    tab_g = order_clusters(build_clusters(rt_g._scene_arrays,
                                          n_active=rt_g._n_active),
                           cam_g.position)
    t0 = time.perf_counter()
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_cluster_reference(
            None, cam_g, batch_seed(13 + 1, f), prebuilt=tab_g,
            pre_ordered=True, **INTERACTIVE, **ALL_FLAGS)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    torch.cuda.synchronize(dev)
    stats = compare(acc, acc_p)
    cluster_flags_err = max(cluster_flags_err, stats["max_abs"])
    print(f"[20 flags main path] glass field vs the plain chain at the same "
          f"size (640x480/8spp/d4, {time.perf_counter() - t0:.1f} s): "
          f"accumulator {stats}")
    check_exact(stats, "glass field main path accumulator")

    # (c) the headless app with a thin lens
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "dof.png"
        render_megakernel.launches = 0
        rc = app_run.main(["--headless", "--device", "cuda", "--width", "160",
                           "--height", "120", "--samples", "8", "--batch",
                           "8", "--depth", "4", "--aperture", "0.1",
                           "--focus-dist", "3", "--output", str(png)])
        check(rc == 0 and (png.exists() or png.with_suffix(".png.npy")
                           .exists()), "app --aperture wrote its image")
        check(render_megakernel.launches == 1,
              "app --aperture: one megakernel batch")
    print(f"[20 flags main path] python -m tpu_rt_torch.app.run --headless "
          f"--aperture 0.1 --focus-dist 3: rc {rc}, megakernel launches "
          f"{render_megakernel.launches}")

    # (d) the display at 4K UHD (more values than torch.quantile takes)
    uhd = torch.rand((2160, 3840, 3), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev) * 1.5
    uhd_stack = display_stack(uhd, EXPOSURE, as_uint8=True)
    torch.cuda.synchronize(dev)
    check(tuple(uhd_stack.shape) == (2, 2160, 3840, 3)
          and int(uhd_stack[1].max()) == 255 and int(uhd_stack[1].min()) == 0,
          "4K UHD display_stack stretches its enhanced row")
    print("[20 display] display_stack at 3840x2160: "
          f"{tuple(uhd_stack.shape)} {uhd_stack.dtype}")

    # ---- 21. statistics: demo-scene means with all three flags ----
    cam21 = cam_for(64, 48, aperture=0.1)

    def flags_mean(n, seed0):
        acc_m = torch.zeros((48, 64, 3), dtype=torch.float64, device=dev)
        for i in range(n):
            acc_m += render_megakernel(scene, cam21, (seed0 + i) * (1 << 16),
                                       width=64, height=48, spp=64,
                                       max_depth=4, n_active=N_ACTIVE,
                                       **ALL_FLAGS)
        return acc_m / n

    ref_mean = flags_mean(512, 60000)
    r8 = float(torch.sqrt(((flags_mean(8, 70000) - ref_mean) ** 2).mean()))
    r32 = float(torch.sqrt(((flags_mean(32, 71000) - ref_mean) ** 2).mean()))
    print(f"[21 flags statistics] demo scene, all three flags, "
          f"64x48/64spp/d4: RMSE vs the N=512 kernel mean: N=8 {r8:.6f}, "
          f"N=32 {r32:.6f}, ratio {r8 / r32:.3f} (1.955 expected)")
    check(r32 < r8 and 1.4 < r8 / r32 < 2.8, "flags 1/sqrt(N) scaling")

    # ---- 22. timing ----
    def in_turns(fns, frames):
        times = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which] += cuda_frame_ms(fns[which], frames, device=dev)
        return {k: statistics.median(v) for k, v in times.items()}

    k1_bytes = (N_ACTIVE * 16 + 16 + 3) * 4
    mega_flags = None
    for name, shape in (("640x480/8spp/d4", INTERACTIVE),
                        ("1080p/4spp/d4", BENCH)):
        n_pix = shape["width"] * shape["height"]
        cam_t = cam_for(shape["width"], shape["height"], aperture=0.1)
        kw = dict(n_active=N_ACTIVE, **shape, **ALL_FLAGS)
        if mega_flags is None:  # the main path: RayTracer, as in phase 20
            label = f"K1 all flags RayTracer demo scene {name}"
            fn = (lambda i: rt_f.render_device(
                INTERACTIVE["width"], INTERACTIVE["height"],
                INTERACTIVE["spp"], INTERACTIVE["max_depth"]))
            cam_t = rt_f.camera.to_params(dev)
        else:
            label = f"K1 all flags demo scene {name}"
            fn = (lambda i: render_megakernel(scene, cam_t, 900 + i, **kw))
        k_ms, ev_ms, frame, bnd = mesh_timing(
            label, fn,
            lambda: render_megakernel(scene, cam_t, 0, with_stats=True,
                                      with_visits=True, **kw)[1:],
            n_pix, shape["spp"], "megakernel", (N_ACTIVE, 0),
            k1_bytes + (-(-n_pix // 4096)) * 4, ALL_FLAGS, 22)
        mp = in_turns({
            "kernel": lambda i: render_megakernel(scene, cam_t, 950 + i, **kw),
            "plain": lambda i: render_megakernel_reference(scene, cam_t,
                                                           950 + i, **kw)},
            3)
        print(f"[22 timing] {label}: kernel frame {mp['kernel']:.4f} ms, "
              f"plain {mp['plain']:.4f} ms (median of 2x3 chained frames "
              f"each, in turns)")
        if mega_flags is None:
            mega_flags = {"name": "megakernel-refract-dof-stratify",
                          "route": "cuda",
                          "source": "tpu_rt_torch/csrc/megakernel.cu",
                          "replaces": "tpu_rt/ops/pallas_megakernel.py:490",
                          "launches": flags_launches,
                          "max_abs_err": mega_flags_err, "ms": k_ms,
                          "event_ms": ev_ms,
                          "plain_ms": mp["plain"], **bnd,
                          "library_ms": None,
                          "shape": f"RayTracer demo scene, refraction + DOF "
                                   f"+ stratify, {name}",
                          "plain_shape": name, "frame_ms": frame}

    refract_dof = dict(enable_refraction=True, enable_dof=True)
    cam22 = cam_for(BENCH["width"], BENCH["height"], aperture=0.2,
                    **FIELD_CAM)
    tab22 = order_clusters(build_clusters(field, n_active=BIG["n"]),
                           cam22.position)
    # the same scene without the flags first: the flags' own cost
    for label, flags in (("no flags", {}), ("refraction + DOF", refract_dof)):
        kw = dict(prebuilt=tab22, pre_ordered=True, **BENCH, **flags)
        mesh_timing(f"K2 glass field {label} 1080p/4spp/d4",
                    lambda i: render_cluster(None, cam22, 1000 + i, **kw),
                    lambda: render_cluster(None, cam22, 0, with_stats=True,
                                           with_visits=True, **kw)[1:],
                    BENCH["width"] * BENCH["height"], BENCH["spp"],
                    "cluster_kernel", k2_floor(tab22),
                    table_bytes(tab22) + 16 * 4, flags, 22)
    # the glass field's main path (phase 20 (b)): refraction, DOF, stratify
    k_g, ev_g, frame_g, bnd_g = mesh_timing(
        "K2 all flags RayTracer glass field 640x480/8spp/d4",
        lambda i: rt_g.render_device(INTERACTIVE["width"],
                                     INTERACTIVE["height"],
                                     INTERACTIVE["spp"],
                                     INTERACTIVE["max_depth"]),
        lambda: render_cluster(None, cam_g, 0, prebuilt=tab_g,
                               pre_ordered=True, with_stats=True,
                               with_visits=True, **INTERACTIVE,
                               **ALL_FLAGS)[1:],
        INTERACTIVE["width"] * INTERACTIVE["height"], INTERACTIVE["spp"],
        "cluster_kernel", k2_floor(tab_g), table_bytes(tab_g) + 16 * 4,
        ALL_FLAGS, 22)
    # the plain version at 256x128 only: its sweep is O(N) per ray
    kw = dict(prebuilt=tab19, pre_ordered=True, **PLAIN_SHAPE, **ALL_FLAGS)
    mp = in_turns({
        "kernel": lambda i: render_cluster(None, cam19, 1100 + i, **kw),
        "plain": lambda i: render_cluster_reference(None, cam19, 1100 + i,
                                                    **kw)}, 3)
    print(f"[22 timing] K2 all flags glass field 256x128/4spp/d4 (the plain "
          f"version's shape): kernel {mp['kernel']:.4f} ms, plain "
          f"{mp['plain']:.4f} ms (median of 2x3 chained frames each, in "
          f"turns)")
    cluster_flags = {"name": "cluster-refract-dof-stratify", "route": "cuda",
                     "source": "tpu_rt_torch/csrc/cluster.cu",
                     "replaces": "tpu_rt/ops/pallas_cluster.py:1375",
                     "launches": glass_launches,
                     "max_abs_err": cluster_flags_err, "ms": k_g,
                     "event_ms": ev_g,
                     "plain_ms": mp["plain"], **bnd_g, "library_ms": None,
                     "shape": "RayTracer glass field (10k spheres), "
                              "refraction + DOF + stratify, 640x480/8spp/d4",
                     "frame_ms": frame_g,
                     "plain_shape": "glass field 256x128/4spp/d4",
                     "frame_ms_at_plain_shape": mp["kernel"]}

    # ================= next-event estimation, linear output ================
    from tpu_rt_torch.ops.cluster import light_table
    from tpu_rt_torch.ops.megakernel import light_cdf

    NEE = dict(nee=True)
    NEE_CAM = dict(position=(0, 1.0, 2.0), target=(0, 0.2, -3))

    def spheres_of(rows):
        return tpu_rt_torch.make_scene(**rows, device=dev)

    # the Cornell box's spheres and a bulb under its ceiling: the walls
    # occlude the shadow rays (the box's own light is a triangle, which NEE
    # does not sample)
    bulb = spheres_of(dict(
        centers=[(-0.8, 0.6, -3.5), (0.8, 0.5, -2.5), (0.0, 3.3, -3.0)],
        radii=[0.6, 0.5, 0.25],
        albedos=[(0.95, 0.95, 0.95), (0.8, 0.7, 0.3), (1.0, 1.0, 1.0)],
        metallics=[1.0, 0.0, 0.0], roughnesses=[0.02, 0.4, 0.0],
        emissions=[(0, 0, 0), (0, 0, 0), (10.0, 9.0, 8.0)],
        background=(0.0, 0.0, 0.0)))
    bulb_active = dict(mesh=cm, n_active=4, n_tri_active=12)

    def nee_scene(light=True, blocker=False):
        """tests/test_nee.py:nee_scene: ground, a diffuse ball, a rough
        metal ball, one small bright light, optionally an opaque blocker
        between the light and the diffuse ball."""
        rows = [((0, -100.5, -3), 100.0, (0.6, 0.6, 0.6), 0.0, 0.5,
                 (0, 0, 0)),
                ((0, 0.2, -3), 0.7, (0.7, 0.3, 0.3), 0.0, 0.5, (0, 0, 0)),
                ((1.2, 0.2, -3), 0.5, (0.8, 0.8, 0.4), 1.0, 0.4, (0, 0, 0))]
        if light:
            rows.append(((-1.0, 2.5, -2.5), 0.35, (1.0, 1.0, 1.0), 0.0, 0.0,
                         (14.0, 12.0, 10.0)))
        if blocker:
            rows.append(((-0.5, 1.3, -2.75), 0.45, (0.2, 0.2, 0.2), 0.0, 0.5,
                         (0, 0, 0)))
        cols = list(zip(*rows))
        return spheres_of(dict(centers=cols[0], radii=cols[1],
                               albedos=cols[2], metallics=cols[3],
                               roughnesses=cols[4], emissions=cols[5],
                               background=(0.0, 0.0, 0.0)))

    blocker = nee_scene(blocker=True)

    # ---- 23. K1-nee: kernel vs plain, bit for bit ----
    cam23 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"], aperture=0.1)
    cam23c = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"],
                     **CORNELL_CAM)
    cam23b = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"], **NEE_CAM)
    demo_kw = dict(n_active=N_ACTIVE)
    k1_cases = [
        ("demo scene", scene, cam23, demo_kw, NEE),
        ("demo scene + refraction + DOF + stratify", scene, cam23, demo_kw,
         dict(NEE, **ALL_FLAGS)),
        ("demo scene, linear", scene, cam23, demo_kw, dict(NEE, gamma=False)),
        ("Cornell box + bulb", bulb, cam23c, bulb_active, NEE),
        ("blocker scene", blocker, cam23b, dict(n_active=8), NEE)]
    mega_nee_err = 0.0
    for label, sc, cam_, kw_s, flags in k1_cases:
        for seed in (7, 2**31 - 2):
            kw = dict(with_stats=True, **kw_s, **PLAIN_SHAPE, **flags)
            a, seg_a = render_megakernel(sc, cam_, seed, **kw)
            b, seg_b = render_megakernel_reference(sc, cam_, seed, **kw)
            stats = compare(a, b)
            mega_nee_err = max(mega_nee_err, stats["max_abs"])
            print(f"[23 K1-nee vs plain] {label} 256x128/4spp/d4 seed "
                  f"{seed}: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K1-nee {label} seed {seed}", (seg_a, seg_b))
    kw = dict(n_active=N_ACTIVE, with_stats=True, **PLAIN_SHAPE)
    a, seg_a = render_megakernel(scene, cam23, 7, nee=True, **kw)
    b, seg_b = render_megakernel(scene, cam23, 7, **kw)
    check(not torch.equal(a, b) and int(seg_a) > int(seg_b),
          "K1: NEE changes the image and adds shadow segments")

    # ---- 24. K1-nee main paths ----
    # (a) the demo scene: RayTracer(seed, mode, enable_refraction, linear,
    # nee) with nee=True -> the megakernel
    rt_n = RayTracer(15, "v2", False, False, True, device=dev)
    rt_n.set_scene(demo_api_scene())
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_n)
    nee_launches = render_megakernel.launches
    print(f"[24 K1-nee main path] RayTracer(nee=True), demo scene (3 lights "
          f"in a bucket of 16), x4 at 640x480/8spp/d4: megakernel launches "
          f"{nee_launches}, cluster launches {render_cluster.launches}")
    check(nee_launches == 4, "the NEE main path launched the megakernel 4x")
    check(render_cluster.launches == 0, "the demo scene skips the cluster")
    check_stack(stack, acc, "NEE main path")
    cam_n = rt_n.camera.to_params(dev)
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_megakernel_reference(
            rt_n._scene_arrays, cam_n, batch_seed(15 + 1, f),
            n_active=N_ACTIVE, nee=True, **INTERACTIVE)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    stats = compare(acc, acc_p)
    mega_nee_err = max(mega_nee_err, stats["max_abs"])
    print(f"[24 K1-nee main path] vs the plain chain: accumulator {stats}")
    check_exact(stats, "NEE main path accumulator")

    # (b) the Cornell box with a bulb: RayTracer + set_mesh + set_nee(True)
    rt_cn = RayTracer(19, device=dev)
    rt_cn.set_scene(api_scene_of(bulb))
    rt_cn.set_mesh(cm)
    aim(rt_cn, CORNELL_CAM)
    rt_cn.set_nee(True)
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_cn)
    nee_tri_launches = render_megakernel.launches
    print(f"[24 K1-nee main path] RayTracer + set_mesh(Cornell box) + "
          f"set_nee(True), 2 spheres and a bulb, x4 at 640x480/8spp/d4: "
          f"megakernel launches {nee_tri_launches}, cluster launches "
          f"{render_cluster.launches}")
    check(nee_tri_launches == 4, "the Cornell NEE path launched K1 4 times")
    check(render_cluster.launches == 0, "the Cornell box skips the cluster")
    check_stack(stack, acc, "Cornell NEE main path")
    cam_cn = rt_cn.camera.to_params(dev)
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_megakernel_reference(
            rt_cn._scene_arrays, cam_cn, batch_seed(19 + 1, f), nee=True,
            **bulb_active, **INTERACTIVE)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    stats = compare(acc, acc_p)
    mega_nee_err = max(mega_nee_err, stats["max_abs"])
    print(f"[24 K1-nee main path] Cornell + bulb vs the plain chain: "
          f"accumulator {stats}")
    check_exact(stats, "Cornell NEE main path accumulator")

    # timing: the two main paths, then the JAX bench's NEE row
    # (benchmarks/bench_scenes.py:206) at 1080p/4spp/d4
    n_int = INTERACTIVE["width"] * INTERACTIVE["height"]
    kw = dict(n_active=N_ACTIVE, nee=True, **INTERACTIVE)
    k_ms, ev_ms, frame, bnd = mesh_timing(
        "K1-nee RayTracer demo scene 640x480/8spp/d4",
        lambda i: rt_n.render_device(
            INTERACTIVE["width"], INTERACTIVE["height"], INTERACTIVE["spp"],
            INTERACTIVE["max_depth"]),
        lambda: render_megakernel(scene, cam_n, 0, with_stats=True,
                                  with_visits=True, **kw)[1:],
        n_int, INTERACTIVE["spp"], "megakernel", (N_ACTIVE, 0),
        k1_bytes + 4 + (-(-n_int // 4096)) * 4, NEE, 24)
    mp = in_turns({
        "kernel": lambda i: render_megakernel(scene, cam_n, 1200 + i, **kw),
        "plain": lambda i: render_megakernel_reference(scene, cam_n,
                                                       1200 + i, **kw)}, 3)
    print(f"[24 timing] K1-nee demo scene 640x480/8spp/d4: kernel frame "
          f"{mp['kernel']:.4f} ms, plain {mp['plain']:.4f} ms (median of 2x3 "
          f"chained frames each, in turns)")
    mega_nee = {"name": "megakernel-nee", "route": "cuda",
                "source": "tpu_rt_torch/csrc/megakernel.cu",
                "replaces": "tpu_rt/ops/pallas_megakernel.py:525",
                "launches": nee_launches, "max_abs_err": mega_nee_err,
                "ms": k_ms, "event_ms": ev_ms, "plain_ms": mp["plain"],
                **bnd, "library_ms": None,
                "shape": "RayTracer(nee=True) demo scene 640x480/8spp/d4",
                "plain_shape": "640x480/8spp/d4", "frame_ms": frame}
    kw_c = dict(nee=True, **bulb_active, **INTERACTIVE)
    mesh_timing(
        "K1-nee RayTracer Cornell box + bulb 640x480/8spp/d4",
        lambda i: rt_cn.render_device(
            INTERACTIVE["width"], INTERACTIVE["height"], INTERACTIVE["spp"],
            INTERACTIVE["max_depth"]),
        lambda: render_megakernel(bulb, cam_cn, 0, with_stats=True,
                                  with_visits=True, **kw_c)[1:],
        n_int, INTERACTIVE["spp"], "megakernel", k1_tri_prims,
        k1_tri_bytes + 4 + (-(-n_int // 4096)) * 4, NEE, 24)
    cam24 = cam_for(BENCH["width"], BENCH["height"])
    n_bench = BENCH["width"] * BENCH["height"]
    kw_b = dict(n_active=N_ACTIVE, nee=True, **BENCH)
    mesh_timing(
        "K1-nee demo scene 1080p/4spp/d4",
        lambda i: render_megakernel(scene, cam24, 1300 + i, **kw_b),
        lambda: render_megakernel(scene, cam24, 0, with_stats=True,
                                  with_visits=True, **kw_b)[1:],
        n_bench, BENCH["spp"], "megakernel", (N_ACTIVE, 0),
        k1_bytes + 4 + (-(-n_bench // 4096)) * 4, NEE, 24)

    # ---- 25. K2-nee: kernel vs plain, bit for bit ----
    lt_field = light_table(field)
    field_kw = dict(prebuilt=tab19, pre_ordered=True, lights=lt_field)
    rng = np.random.default_rng(12)
    n12 = 100
    em12 = np.zeros((n12, 3), np.float32)
    em12[np.arange(3, n12, 8)[:12]] = rng.uniform(2, 8, (12, 3))
    twelve = spheres_of(dict(
        centers=np.c_[rng.uniform(-8, 8, n12), rng.uniform(0.3, 2.5, n12),
                      rng.uniform(-14, -2, n12)].astype(np.float32),
        radii=rng.uniform(0.2, 0.6, n12).astype(np.float32),
        albedos=rng.uniform(0.1, 0.9, (n12, 3)).astype(np.float32),
        metallics=np.where(rng.uniform(size=n12) < 0.2, 1.0, 0.0).astype(
            np.float32),
        roughnesses=rng.uniform(0, 0.6, n12).astype(np.float32),
        emissions=em12, background=(0.1, 0.1, 0.15)))
    check(float(light_table(twelve)[-1]) == 8.0,
          "12 lights: the table takes the first 8")
    cam25 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"],
                    position=(0, 4, 8), target=(0, 0.5, -8))
    k2_cases = [
        ("glass field (10k)", None, cam19, field_kw, NEE),
        ("glass field + refraction + DOF + stratify", None, cam19, field_kw,
         dict(NEE, **ALL_FLAGS)),
        ("glass field, linear", None, cam19, field_kw, dict(NEE, gamma=False)),
        ("terrain 10k", ts, cam14, dict(mesh=tm), NEE),
        ("terrain 10k + refraction + DOF", ts, cam19t, dict(mesh=tm),
         dict(NEE, enable_refraction=True, enable_dof=True)),
        ("Cornell box + bulb", bulb, cam23c, dict(mesh=cm), NEE),
        ("blocker scene", blocker, cam23b, {}, NEE),
        ("12 lights (cap 8)", twelve, cam25, {}, NEE)]
    cluster_nee_err = 0.0
    for label, sc, cam_, kw_s, flags in k2_cases:
        for seed in (7, 2**31 - 2):
            kw = dict(with_stats=True, **kw_s, **PLAIN_SHAPE, **flags)
            a, seg_a = render_cluster(sc, cam_, seed, **kw)
            b, seg_b = render_cluster_reference(sc, cam_, seed, **kw)
            stats = compare(a, b)
            cluster_nee_err = max(cluster_nee_err, stats["max_abs"])
            print(f"[25 K2-nee vs plain] {label} 256x128/4spp/d4 seed "
                  f"{seed}: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K2-nee {label} seed {seed}", (seg_a, seg_b))
    # the blocker scene through render(engine="cluster"), linear
    before = render_cluster.launches
    kw = dict(with_stats=True, nee=True, gamma=False, **PLAIN_SHAPE)
    a, seg_a = render(blocker, cam23b, 7, engine="cluster", **kw)
    check(render_cluster.launches == before + 1,
          "engine='cluster' with NEE launched the cluster kernel")
    b, seg_b = render_cluster_reference(blocker, cam23b, 7, n_active=8, **kw)
    stats = compare(a, b)
    print(f"[25 K2-nee vs plain] blocker scene through engine='cluster', "
          f"linear: {stats}, segments {int(seg_a)} vs {int(seg_b)}")
    check_exact(stats, "K2-nee engine='cluster'", (seg_a, seg_b))

    # ---- 26. K2-nee main path: 10k spheres as Scene objects ----
    rt_k = RayTracer(17, "v2", False, False, True, device=dev)
    rt_k.set_scene(api_scene)
    aim(rt_k, BIG_CAM)
    render_megakernel.launches = render_cluster.launches = 0
    acc, stack = main_path(rt_k)
    cluster_nee_launches = render_cluster.launches
    print(f"[26 K2-nee main path] RayTracer(nee=True), 10k spheres (the "
          f"table's 8 of {int(light_cdf(rt_k._scene_arrays)[-1])} lights), x4 "
          f"at 640x480/8spp/d4: cluster launches {cluster_nee_launches}, "
          f"megakernel launches {render_megakernel.launches}")
    check(cluster_nee_launches == 4, "the K2 NEE path launched the cluster 4x")
    check(render_megakernel.launches == 0, "10k spheres skip the megakernel")
    check_stack(stack, acc, "K2 NEE main path")
    cam_k = rt_k.camera.to_params(dev)
    tab_k = order_clusters(build_clusters(rt_k._scene_arrays,
                                          n_active=rt_k._n_active),
                           cam_k.position)
    lt_k = light_table(rt_k._scene_arrays)
    t0 = time.perf_counter()
    acc_p, total_p = None, 0
    for f in range(4):
        b = render_cluster_reference(
            None, cam_k, batch_seed(17 + 1, f), prebuilt=tab_k,
            pre_ordered=True, nee=True, lights=lt_k, **INTERACTIVE)
        acc_p, total_p = accumulate(acc_p, total_p, b, INTERACTIVE["spp"])
    torch.cuda.synchronize(dev)
    stats = compare(acc, acc_p)
    cluster_nee_err = max(cluster_nee_err, stats["max_abs"])
    print(f"[26 K2-nee main path] vs the plain chain at the same size "
          f"(640x480/8spp/d4, {time.perf_counter() - t0:.1f} s): accumulator "
          f"{stats}")
    check_exact(stats, "K2 NEE main path accumulator")

    lt_bytes = lt_k.numel() * 4
    kw = dict(prebuilt=tab_k, pre_ordered=True, nee=True, lights=lt_k,
              **INTERACTIVE)
    k_n, ev_n, frame_n, bnd_n = mesh_timing(
        "K2-nee RayTracer 10k spheres 640x480/8spp/d4",
        lambda i: rt_k.render_device(
            INTERACTIVE["width"], INTERACTIVE["height"], INTERACTIVE["spp"],
            INTERACTIVE["max_depth"]),
        lambda: render_cluster(None, cam_k, 0, with_stats=True,
                               with_visits=True, **kw)[1:],
        n_int, INTERACTIVE["spp"], "cluster_kernel", k2_floor(tab_k),
        table_bytes(tab_k) + lt_bytes + 16 * 4, NEE, 26)
    # the JAX bench's NEE rows (benchmarks/bench_scenes.py:213-258)
    for label, tab_, cam_, lt, tri_ in (
            ("10k spheres", tab_a, cam_a, light_table(big), None),
            ("100k spheres", tab_c, cam_a, light_table(huge), None)):
        kw = dict(prebuilt=tab_, pre_ordered=True, nee=True, lights=lt,
                  **BENCH)
        mesh_timing(f"K2-nee {label} 1080p/4spp/d4",
                    lambda i: render_cluster(None, cam_, 1400 + i, **kw),
                    lambda: render_cluster(None, cam_, 0, with_stats=True,
                                           with_visits=True, **kw)[1:],
                    n_bench, BENCH["spp"], "cluster_kernel",
                    k2_floor(tab_),
                    table_bytes(tab_) + lt_bytes + 16 * 4, NEE, 26)
    tab_t = order_clusters(build_clusters(ts, n_active=3), cam_b.position)
    tri_t = order_clusters(build_tri_clusters(tm), cam_b.position)
    kw = dict(prebuilt=tab_t, tri_prebuilt=tri_t, pre_ordered=True, nee=True,
              lights=light_table(ts), **BENCH)
    mesh_timing("K2-nee terrain 10k 1080p/4spp/d4",
                lambda i: render_cluster(None, cam_b, 1500 + i, **kw),
                lambda: render_cluster(None, cam_b, 0, with_stats=True,
                                       with_visits=True, **kw)[1:],
                n_bench, BENCH["spp"], "cluster_kernel",
                k2_floor(tab_t, tri_t),
                table_bytes(tab_t, tri_t) + lt_bytes + 16 * 4, NEE, 26)
    # the plain version at 256x128 only: its sweep is O(N) per ray
    tab_9 = order_clusters(build_clusters(big, n_active=BIG["n"]),
                           cam9.position)
    kw = dict(prebuilt=tab_9, pre_ordered=True, nee=True,
              lights=light_table(big), **PLAIN_SHAPE)
    mp = in_turns({
        "kernel": lambda i: render_cluster(None, cam9, 1600 + i, **kw),
        "plain": lambda i: render_cluster_reference(None, cam9, 1600 + i,
                                                    **kw)}, 3)
    print(f"[26 timing] K2-nee 10k spheres 256x128/4spp/d4 (the plain "
          f"version's shape): kernel {mp['kernel']:.4f} ms, plain "
          f"{mp['plain']:.4f} ms (median of 2x3 chained frames each, in "
          f"turns)")
    cluster_nee = {"name": "cluster-nee", "route": "cuda",
                   "source": "tpu_rt_torch/csrc/cluster.cu",
                   "replaces": "tpu_rt/ops/pallas_cluster.py:1408",
                   "launches": cluster_nee_launches,
                   "max_abs_err": cluster_nee_err, "ms": k_n,
                   "event_ms": ev_n, "plain_ms": mp["plain"],
                   **bnd_n, "library_ms": None,
                   "shape": "RayTracer(nee=True) 10k spheres 640x480/8spp/d4",
                   "frame_ms": frame_n,
                   "plain_shape": "10k spheres 256x128/4spp/d4",
                   "frame_ms_at_plain_shape": mp["kernel"]}

    # ---- 27. statistics, in linear output ----
    sw, sh, sspp = 48, 36, 48
    cam27 = cam_for(sw, sh, **NEE_CAM)

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float32)  # RNE, as K2 packs

    # (a) K1 and K2 NEE means on the dome + interior light
    # (tests/test_multilight.py:55-74), materials in bf16 on both sides
    dome = spheres_of(dict(
        centers=[(0.0, -100.5, -3.0), (0.0, 0.2, -3.0), (0.0, 0.0, -3.0),
                 (-1.0, 2.5, -2.5)],
        radii=[100.0, 0.7, 60.0, 0.35],
        albedos=[(0.6, 0.6, 0.6), (0.7, 0.3, 0.3), (0.0, 0.0, 0.0),
                 (1.0, 1.0, 1.0)],
        metallics=[0.0, 0.0, 0.0, 0.0], roughnesses=[0.5, 0.5, 1.0, 0.0],
        emissions=[(0, 0, 0), (0, 0, 0), (0.5, 0.6, 0.8),
                   (14.0, 12.0, 10.0)],
        background=(0.0, 0.0, 0.0)))
    dome = dome._replace(albedo=bf16(dome.albedo),
                         metallic=bf16(dome.metallic),
                         roughness=bf16(dome.roughness),
                         emission=bf16(dome.emission), ior=bf16(dome.ior))
    n_frames = 32
    kw = dict(width=sw, height=sh, spp=sspp, max_depth=4, nee=True,
              gamma=False)
    k1_frames = np.stack([render_megakernel(
        dome, cam27, 40 + k * (1 << 16), n_active=dome.capacity,
        **kw).cpu().numpy() for k in range(n_frames)])
    k2_frames = np.stack([render(
        dome, cam27, 50 + k * (1 << 16), engine="cluster",
        **kw).cpu().numpy() for k in range(n_frames)])
    gap, se = mean_gap(k1_frames, k2_frames)
    print(f"[27 NEE statistics] dome + interior light (bf16 materials), "
          f"{sw}x{sh}/{sspp}spp/d4 linear, {n_frames} frames each: K1 mean "
          f"{k1_frames.mean():.6f}, K2 mean {k2_frames.mean():.6f}, gap "
          f"{gap:.6f} = {gap / se:.2f} standard errors")
    check(gap <= 3.0 * se, "K1 and K2 NEE means agree within 3 SE")

    # (b) NEE's per-pixel variance against the plain estimator's, equal spp
    lit = nee_scene()
    var = {}
    for engine_name, fn in (("K1", render_megakernel), ("K2", render_cluster)):
        for on in (True, False):
            frames_ = torch.stack([fn(
                lit, cam27, 60 + k * (1 << 16), width=sw, height=sh, spp=16,
                max_depth=4, nee=on, gamma=False) for k in range(n_frames)])
            var[engine_name, on] = float(frames_.var(dim=0).mean())
        ratio = var[engine_name, False] / var[engine_name, True]
        print(f"[27 NEE statistics] nee_scene() {sw}x{sh}/16spp/d4 linear, "
              f"{engine_name}: per-pixel variance {var[engine_name, True]:.6f}"
              f" with NEE, {var[engine_name, False]:.6f} without: "
              f"{ratio:.2f}x lower")
        check(ratio >= 2.0, f"{engine_name}: NEE's variance at least 2x lower")

    # (c) 1/sqrt(N) with NEE: demo-scene means against an N=512 kernel mean
    cam27d = cam_for(64, 48)

    def nee_mean(n, seed0):
        acc_m = torch.zeros((48, 64, 3), dtype=torch.float64, device=dev)
        for i in range(n):
            acc_m += render_megakernel(scene, cam27d, (seed0 + i) * (1 << 16),
                                       width=64, height=48, spp=64,
                                       max_depth=4, n_active=N_ACTIVE,
                                       nee=True)
        return acc_m / n

    ref_mean = nee_mean(512, 80000)
    r8 = float(torch.sqrt(((nee_mean(8, 90000) - ref_mean) ** 2).mean()))
    r32 = float(torch.sqrt(((nee_mean(32, 91000) - ref_mean) ** 2).mean()))
    print(f"[27 NEE statistics] demo scene, NEE, 64x48/64spp/d4: RMSE vs the "
          f"N=512 kernel mean: N=8 {r8:.6f}, N=32 {r32:.6f}, ratio "
          f"{r8 / r32:.3f} (1.955 expected)")
    check(r32 < r8 and 1.4 < r8 / r32 < 2.8, "NEE 1/sqrt(N) scaling")

    # ================= adaptive tile masks, bands of rows ==================
    from tpu_rt_torch.ops.megakernel import TILE
    from tpu_rt_torch.render.frame import (
        accumulate_tiled, accumulate_tiled_mapped, cluster_tile_map)

    mask_rng = np.random.default_rng(28)

    def share_mask(n, share):
        """A random mask of n tiles with about ``share`` of them on (at
        least one on, and one off unless share is 1)."""
        if share >= 1.0:
            return np.ones(n, np.int32)
        m = (mask_rng.uniform(size=n) < share).astype(np.int32)
        first, second = mask_rng.permutation(n)[:2]
        m[first], m[second] = 1, 0
        return m

    def k1_on(mask, n_pix, shape):
        """The pixels of a megakernel render whose tile is on."""
        return torch.from_numpy(np.repeat(mask != 0, TILE)[:n_pix]).to(
            dev).reshape(shape)

    def k2_on(mask, w, h):
        tmap, _ = cluster_tile_map(w, h, device=dev)
        return torch.from_numpy(mask).to(dev)[tmap.long()] != 0

    # every instantiation: no mesh / mesh x flag-free / kFlags / kNee
    K1_CASES = [("demo scene", scene, dict(n_active=N_ACTIVE), {}),
                ("demo scene", scene, dict(n_active=N_ACTIVE), ALL_FLAGS),
                ("demo scene", scene, dict(n_active=N_ACTIVE),
                 dict(NEE, **ALL_FLAGS)),
                ("Cornell box + bulb", bulb, bulb_active, {}),
                ("Cornell box + bulb", bulb, bulb_active, ALL_FLAGS),
                ("Cornell box + bulb", bulb, bulb_active,
                 dict(NEE, **ALL_FLAGS))]
    K2_CASES = [("glass field (10k)", None, cam19, field_kw, {}),
                ("glass field (10k)", None, cam19, field_kw, ALL_FLAGS),
                ("glass field (10k)", None, cam19, field_kw,
                 dict(NEE, **ALL_FLAGS)),
                ("terrain 10k", ts, cam19t, dict(mesh=tm), {}),
                ("terrain 10k", ts, cam19t, dict(mesh=tm), ALL_FLAGS),
                ("terrain 10k", ts, cam19t, dict(mesh=tm),
                 dict(NEE, **ALL_FLAGS))]

    def flag_label(flags):
        return ("kNee" if flags.get("nee") else "kFlags" if flags
                else "flag-free")

    # ---- 28. tile masks: kernel vs plain in every instantiation, and the
    # masked kernel against the unmasked kernel at full size ----
    cam28 = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"], aperture=0.1)
    cam28c = cam_for(PLAIN_SHAPE["width"], PLAIN_SHAPE["height"],
                     aperture=0.1, **CORNELL_CAM)
    mask8 = share_mask(8, 0.5)  # PLAIN_SHAPE: 8 tiles, or 2 x 4 blocks
    print(f"[28 tile masks] mask of the 256x128 frames: {mask8.tolist()}")
    mega_mask_err = cluster_mask_err = 0.0
    for label, sc, kw_s, flags in K1_CASES:
        cam_ = cam28c if sc is bulb else cam28
        for seed in (7, 2**31 - 2):
            kw = dict(with_stats=True, tile_mask=mask8, **kw_s, **PLAIN_SHAPE,
                      **flags)
            a, seg_a = render_megakernel(sc, cam_, seed, **kw)
            b, seg_b = render_megakernel_reference(sc, cam_, seed, **kw)
            stats = compare(a, b)
            mega_mask_err = max(mega_mask_err, stats["max_abs"])
            print(f"[28 K1 mask vs plain] {label} {flag_label(flags)} "
                  f"256x128/4spp/d4 seed {seed}: {stats}, segments "
                  f"{int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K1 mask {label} {flag_label(flags)} seed "
                        f"{seed}", (seg_a, seg_b))
    for label, sc, cam_, kw_s, flags in K2_CASES:
        for seed in (7, 2**31 - 2):
            kw = dict(with_stats=True, tile_mask=mask8, **kw_s, **PLAIN_SHAPE,
                      **flags)
            a, seg_a = render_cluster(sc, cam_, seed, **kw)
            b, seg_b = render_cluster_reference(sc, cam_, seed, **kw)
            stats = compare(a, b)
            cluster_mask_err = max(cluster_mask_err, stats["max_abs"])
            print(f"[28 K2 mask vs plain] {label} {flag_label(flags)} "
                  f"256x128/4spp/d4 seed {seed}: {stats}, segments "
                  f"{int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K2 mask {label} {flag_label(flags)} seed "
                        f"{seed}", (seg_a, seg_b))

    def masked_vs_unmasked(label, fn, n_tiles, on_of):
        """fn(mask or None) -> (image, segments). The masked kernel's active
        tiles equal the unmasked kernel's bit for bit and its skipped tiles
        are zeros; a mask and its complement count the unmasked render's
        segments (each total is scaled to real pixels and truncated, so
        within 1), so the skipped tiles count none."""
        m = share_mask(n_tiles, 0.5)
        full, s_full = fn(None)
        part, s_part = fn(torch.from_numpy(m).to(dev))
        rest, s_rest = fn(torch.from_numpy(1 - m).to(dev))
        on = on_of(m)
        same = bool(torch.equal(part[on], full[on])
                    and torch.equal(rest[~on], full[~on]))
        zeros = not bool(part[~on].any() or rest[on].any())
        gap = int(s_part) + int(s_rest) - int(s_full)
        print(f"[28 masked vs unmasked kernel] {label}: {int(m.sum())} of "
              f"{n_tiles} tiles on; active equal {same}, skipped zero "
              f"{zeros}; segments {int(s_part)} + {int(s_rest)} vs "
              f"{int(s_full)}")
        check(same and zeros and abs(gap) <= 1 and 0 < int(s_part)
              < int(s_full), f"{label}: masked kernel vs unmasked kernel")

    for name, shape in (("640x480/8spp/d4", INTERACTIVE),
                        ("1080p/4spp/d4", BENCH)):
        w, h = shape["width"], shape["height"]
        cam_t = cam_for(w, h)
        masked_vs_unmasked(
            f"K1 demo scene {name}",
            lambda m: render_megakernel(scene, cam_t, 29, tile_mask=m,
                                        with_stats=True, n_active=N_ACTIVE,
                                        **shape),
            -(-w * h // TILE), lambda m: k1_on(m, w * h, (h, w)))
        cam_t = cam_for(w, h, **BIG_CAM)
        tab_t = order_clusters(build_clusters(big, n_active=BIG["n"]),
                               cam_t.position)
        masked_vs_unmasked(
            f"K2 10k spheres {name}",
            lambda m: render_cluster(None, cam_t, 29, tile_mask=m,
                                     prebuilt=tab_t, pre_ordered=True,
                                     with_stats=True, **shape),
            cluster_tile_map(w, h, device="cpu")[1],
            lambda m: k2_on(m, w, h))

    # ---- 29. bands of rows ----
    # K1: the band's own tile seeds, so a band is held against the plain
    # version's band (40 rows: 10240 pixels, the third tile ragged)
    for label, sc, kw_s, flags in K1_CASES:
        cam_ = cam28c if sc is bulb else cam28
        for off in (0, 88):
            kw = dict(with_stats=True, rows=40, row_offset=off, **kw_s,
                      **PLAIN_SHAPE, **flags)
            a, seg_a = render_megakernel(sc, cam_, 7, **kw)
            b, seg_b = render_megakernel_reference(sc, cam_, 7, **kw)
            stats = compare(a, b)
            mega_mask_err = max(mega_mask_err, stats["max_abs"])
            check(tuple(a.shape) == (40, PLAIN_SHAPE["width"], 3),
                  "K1 band shape")
            print(f"[29 K1 band vs plain] {label} {flag_label(flags)} rows "
                  f"[{off}, {off + 40}) of 256x128/4spp/d4: {stats}, "
                  f"segments {int(seg_a)} vs {int(seg_b)}")
            check_exact(stats, f"K1 band {label} {flag_label(flags)} "
                        f"offset {off}", (seg_a, seg_b))
    # K2: kernel band vs plain band in every instantiation
    for label, sc, cam_, kw_s, flags in K2_CASES:
        kw = dict(with_stats=True, rows=64, row_offset=32, **kw_s,
                  **PLAIN_SHAPE, **flags)
        a, seg_a = render_cluster(sc, cam_, 7, **kw)
        b, seg_b = render_cluster_reference(sc, cam_, 7, **kw)
        stats = compare(a, b)
        cluster_mask_err = max(cluster_mask_err, stats["max_abs"])
        print(f"[29 K2 band vs plain] {label} {flag_label(flags)} rows "
              f"[32, 96) of 256x128/4spp/d4: {stats}, segments {int(seg_a)} "
              f"vs {int(seg_b)}")
        check_exact(stats, f"K2 band {label} {flag_label(flags)}",
                    (seg_a, seg_b))

    # K2: streams keyed by the frame's tile, so the kernel's bands stitched
    # together equal its full frame, with NEE and stratify on
    def stitched(label, fn, height, band_rows):
        full, s_full = fn(None, 0)
        parts = [fn(band_rows, o) for o in range(0, height, band_rows)]
        same = bool(torch.equal(torch.cat([p for p, _ in parts]), full))
        total = sum(int(s) for _, s in parts)
        print(f"[29 K2 bands] {label} in bands of {band_rows} rows, "
              f"stitched: equal to the full frame {same}; segments {total} "
              f"vs {int(s_full)}")
        check(same and total == int(s_full), f"{label}: stitched bands")

    strat_nee = dict(NEE, stratify=True)
    cam29 = cam_for(640, 480, **TERRAIN_CAM)
    tab29 = order_clusters(build_clusters(ts, n_active=3), cam29.position)
    tri29 = order_clusters(build_tri_clusters(tm), cam29.position)
    stitched("terrain 10k + NEE + stratify 640x480/8spp/d4",
             lambda r, o: render_cluster(
                 None, cam29, 31, prebuilt=tab29, tri_prebuilt=tri29,
                 pre_ordered=True, lights=light_table(ts), rows=r,
                 row_offset=o, with_stats=True, **INTERACTIVE, **strat_nee),
             480, 160)
    cam29b = cam_for(1920, 1024, **BIG_CAM)
    tab29b = order_clusters(build_clusters(big, n_active=BIG["n"]),
                            cam29b.position)
    stitched("10k spheres + NEE + stratify 1920x1024/4spp/d4",
             lambda r, o: render_cluster(
                 None, cam29b, 32, prebuilt=tab29b, pre_ordered=True,
                 lights=light_table(big), rows=r, row_offset=o,
                 with_stats=True, width=1920, height=1024, spp=4,
                 max_depth=4, **strat_nee),
             1024, 256)

    # ---- 30. the adaptive main paths ----
    def controller(mask, streak, change, target):
        """The app's per-tile rule (tpu_rt/app/interaction.py:935-962): a
        tile's streak grows while it is active and its change is under the
        target; it leaves the mask at a streak of 2."""
        active = mask > 0
        streak = np.where(active & (change < target), streak + 1, 0)
        return (active & (streak < 2)).astype(np.int32), streak

    def adaptive_chain(render_batch, merge, n_tiles, batches, target,
                       display=True):
        """Batches of render_batch(f, mask) -> merge -> the controller (->
        display_stack), until ``batches`` or until every tile has left;
        returns (accumulator, the masks rendered, the last mask, stack)."""
        w, h = INTERACTIVE["width"], INTERACTIVE["height"]
        acc_ = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        counts = torch.zeros((n_tiles,), dtype=torch.float32, device=dev)
        mask = np.ones(n_tiles, np.int32)
        streak = np.zeros(n_tiles, np.int32)
        masks, stack_ = [], None
        for f in range(batches):
            if not mask.any():
                break
            masks.append(mask)
            batch_ = render_batch(f, mask)
            acc_, counts, change = merge(acc_, counts, batch_, torch.from_numpy(
                mask).to(dev), INTERACTIVE["spp"])
            mask, streak = controller(mask, streak, change.cpu().numpy(),
                                      target)
            if display:
                stack_ = display_stack(acc_, EXPOSURE, as_uint8=True)
        torch.cuda.synchronize(dev)
        return acc_, masks, mask, stack_

    # (a) K1: RayTracer(seed=21) on the demo scene, render_device(tile_mask=)
    # -> accumulate_tiled -> the controller -> display_stack, 64 samples
    ADAPTIVE_TARGET = 0.02
    n_int_tiles = -(-n_int // TILE)
    rt_ad = RayTracer(seed=21, device=dev)
    rt_ad.set_scene(demo_api_scene())
    adaptive_flags = []

    def k1_batch(f, mask):
        out = rt_ad.render_device(INTERACTIVE["width"], INTERACTIVE["height"],
                                  INTERACTIVE["spp"],
                                  INTERACTIVE["max_depth"], tile_mask=mask)
        adaptive_flags.append((rt_ad._last_adaptive, rt_ad._last_engine))
        return out

    def k1_merge(acc_, counts, batch_, mask, n):
        return accumulate_tiled(acc_, counts, batch_, mask, n, TILE)

    render_megakernel.launches = render_cluster.launches = 0
    acc, masks, last, stack = adaptive_chain(k1_batch, k1_merge,
                                             n_int_tiles, 8, ADAPTIVE_TARGET)
    adaptive_launches = render_megakernel.launches
    print(f"[30 adaptive main path] RayTracer demo scene 640x480/8spp/d4, "
          f"render_device(tile_mask=) -> accumulate_tiled -> controller "
          f"(noise_target {ADAPTIVE_TARGET}) -> display_stack: "
          f"{len(masks)} batches, active tiles per batch "
          f"{[int(m.sum()) for m in masks]} of {n_int_tiles}; megakernel "
          f"launches {adaptive_launches}, cluster launches "
          f"{render_cluster.launches}; _last_adaptive/_last_engine "
          f"{sorted(set(adaptive_flags))}")
    check(adaptive_launches == len(masks),
          "the adaptive path launched the megakernel once per batch")
    check(render_cluster.launches == 0, "the demo scene skips the cluster")
    check(set(adaptive_flags) == {(True, "pallas")},
          "render_device applied the mask on the pallas engine")
    check(int(last.sum()) < n_int_tiles and any(
        0 < int(m.sum()) < n_int_tiles for m in masks),
        "tiles left the mask, and a batch rendered under a partial mask")
    check_stack(stack, acc, "adaptive main path")
    cam_ad = rt_ad.camera.to_params(dev)
    acc_p, masks_p, _, _ = adaptive_chain(
        lambda f, mask: render_megakernel_reference(
            scene, cam_ad, batch_seed(21 + 1, f), n_active=N_ACTIVE,
            tile_mask=mask, **INTERACTIVE),
        k1_merge, n_int_tiles, 8, ADAPTIVE_TARGET, display=False)
    stats = compare(acc, acc_p)
    mega_mask_err = max(mega_mask_err, stats["max_abs"])
    same_masks = (len(masks_p) == len(masks)
                  and all(map(np.array_equal, masks, masks_p)))
    print(f"[30 adaptive main path] vs the plain chain: accumulator {stats}; "
          f"masks equal {same_masks}")
    check(same_masks, "the plain chain's masks equal the kernel chain's")
    check_exact(stats, "adaptive main path accumulator")

    # (b) K2: render(tile_mask=) on 10k spheres (its engine resolves to the
    # cluster engine; tables built and ordered once) -> accumulate_tiled_mapped
    # over cluster_tile_map -> the controller -> display_stack. Half its
    # blocks are sky (no change at all) and the rest fall under 0.02 at
    # once, so the target is the median change, among the blocks that
    # change, of a second batch over a first at other seeds: the sky and
    # about half the other blocks leave after the third batch. The scene,
    # camera, tables and seeds are phase 10's main path's, whose plain
    # batches give the plain chain's (their masked blocks zeroed).
    cam_k2, tab_k2 = cam10, tables10
    tmap_k2, n_k2_tiles = cluster_tile_map(INTERACTIVE["width"],
                                           INTERACTIVE["height"], device=dev)

    def k2_merge(acc_, counts, batch_, mask, n):
        return accumulate_tiled_mapped(acc_, counts, batch_, mask, n,
                                       tmap_k2, n_k2_tiles)

    ones_k2 = torch.ones((n_k2_tiles,), dtype=torch.int32, device=dev)
    acc_c, counts_c, _ = k2_merge(
        torch.zeros((INTERACTIVE["height"], INTERACTIVE["width"], 3),
                    device=dev), torch.zeros(n_k2_tiles, device=dev),
        render(scene10, cam_k2, 9000, prebuilt=tab_k2, pre_ordered=True,
               **INTERACTIVE), ones_k2, INTERACTIVE["spp"])
    _, _, change_c = k2_merge(acc_c, counts_c, render(
        scene10, cam_k2, 9001, prebuilt=tab_k2, pre_ordered=True,
        **INTERACTIVE), ones_k2, INTERACTIVE["spp"])
    k2_target = float(change_c[change_c > 0].median())
    render_megakernel.launches = render_cluster.launches = 0
    acc, masks2, last2, stack = adaptive_chain(
        lambda f, mask: render(scene10, cam_k2, batch_seed(5 + 1, f),
                               prebuilt=tab_k2, pre_ordered=True,
                               tile_mask=mask, **INTERACTIVE),
        k2_merge, n_k2_tiles, 4, k2_target)
    cluster_mask_launches = render_cluster.launches
    print(f"[30 adaptive main path] render(tile_mask=) 10k spheres "
          f"640x480/8spp/d4 -> accumulate_tiled_mapped -> controller "
          f"(noise_target {k2_target:.6f}) -> display_stack: "
          f"{len(masks2)} batches, active blocks per batch "
          f"{[int(m.sum()) for m in masks2]} of {n_k2_tiles}; cluster "
          f"launches {cluster_mask_launches}, megakernel launches "
          f"{render_megakernel.launches}")
    check(cluster_mask_launches == len(masks2),
          "the K2 adaptive path launched the cluster kernel once per batch")
    check(render_megakernel.launches == 0, "10k spheres skip the megakernel")
    check(int(last2.sum()) < n_k2_tiles and any(
        0 < int(m.sum()) < n_k2_tiles for m in masks2),
        "K2: blocks left the mask, and a batch rendered under a partial mask")
    check_stack(stack, acc, "K2 adaptive path")
    t0 = time.perf_counter()

    def plain_masked(f, mask):
        """render_cluster_reference(tile_mask=mask) of batch f: phase 10's
        plain batch f (the same inputs) with the masked blocks zeroed."""
        on = torch.from_numpy(mask).to(dev)[tmap_k2.long()] != 0
        return torch.where(on[..., None], plain10[f], 0.0)

    acc_p, masks2_p, _, _ = adaptive_chain(
        plain_masked, k2_merge, n_k2_tiles, 4, k2_target, display=False)
    stats = compare(acc, acc_p)
    cluster_mask_err = max(cluster_mask_err, stats["max_abs"])
    same_masks = (len(masks2_p) == len(masks2)
                  and all(map(np.array_equal, masks2, masks2_p)))
    print(f"[30 adaptive main path] K2 vs the plain chain at the same size "
          f"(phase 10's plain batches, masked blocks zeroed; "
          f"{time.perf_counter() - t0:.1f} s): accumulator {stats}; masks "
          f"equal {same_masks}")
    check(same_masks, "K2: the plain chain's masks equal the kernel chain's")
    check_exact(stats, "K2 adaptive path accumulator")

    # ---- 31. timing by active share ----
    shares = (1.0, 0.5, 0.1)
    timed_masks = {}
    k1_share = {}
    for share in shares:
        m = share_mask(n_int_tiles, share)
        md = torch.from_numpy(m).to(dev)
        timed_masks["K1", share] = m
        kw = dict(n_active=N_ACTIVE, tile_mask=md, **INTERACTIVE)
        n_on = int(m.sum()) * TILE
        k1_share[share] = mesh_timing(
            f"K1 tile mask {int(m.sum())} of {n_int_tiles} tiles on "
            f"(~{share:.0%}) demo scene 640x480/8spp/d4",
            lambda i: render_megakernel(scene, cam_ad, 1700 + i, **kw),
            lambda: render_megakernel(scene, cam_ad, 0, with_stats=True,
                                      with_visits=True, **kw)[1:],
            n_on, INTERACTIVE["spp"], "megakernel", (N_ACTIVE, 0),
            k1_bytes + n_int_tiles * 8 + (n_int - n_on) * 12, phase=31)
    kw = dict(n_active=N_ACTIVE, tile_mask=torch.from_numpy(
        timed_masks["K1", 0.5]).to(dev), **INTERACTIVE)
    mp = in_turns({
        "kernel": lambda i: render_megakernel(scene, cam_ad, 1800 + i, **kw),
        "plain": lambda i: render_megakernel_reference(scene, cam_ad,
                                                       1800 + i, **kw)}, 3)
    print(f"[31 timing] K1 tile mask ~50% 640x480/8spp/d4: kernel frame "
          f"{mp['kernel']:.4f} ms, plain {mp['plain']:.4f} ms (median of 2x3 "
          f"chained frames each, in turns)")
    k_ms, ev_ms, frame, bnd = k1_share[0.5]
    mega_mask = {"name": "megakernel-tile-mask", "route": "cuda",
                 "source": "tpu_rt_torch/csrc/megakernel.cu",
                 "replaces": "tpu_rt/ops/pallas_megakernel.py:768",
                 "launches": adaptive_launches,
                 "max_abs_err": mega_mask_err, "ms": k_ms, "event_ms": ev_ms,
                 "plain_ms": mp["plain"], **bnd, "library_ms": None,
                 "shape": f"demo scene 640x480/8spp/d4, "
                          f"{int(timed_masks['K1', 0.5].sum())} of "
                          f"{n_int_tiles} tiles on",
                 "plain_shape": "the same", "frame_ms": frame,
                 "share_ms": {f"{s:.0%}": k1_share[s][0] for s in shares}}

    n_bench_tiles = cluster_tile_map(BENCH["width"], BENCH["height"],
                                     device="cpu")[1]
    k2_share = {}
    for share in shares:
        m = share_mask(n_bench_tiles, share)
        md = torch.from_numpy(m).to(dev)
        timed_masks["K2", share] = m
        kw = dict(prebuilt=tab_a, pre_ordered=True, tile_mask=md, **BENCH)
        n_on = int(k2_on(m, BENCH["width"], BENCH["height"]).sum())
        k2_share[share] = mesh_timing(
            f"K2 tile mask {int(m.sum())} of {n_bench_tiles} blocks on "
            f"(~{share:.0%}) 10k spheres 1080p/4spp/d4",
            lambda i: render_cluster(None, cam_a, 1900 + i, **kw),
            lambda: render_cluster(None, cam_a, 0, with_stats=True,
                                   with_visits=True, **kw)[1:],
            n_on, BENCH["spp"], "cluster_kernel", k2_floor(tab_a),
            table_bytes(tab_a) + 16 * 4 + n_bench_tiles * 4
            + (n_bench - n_on) * 12, phase=31)
    # the plain version at 256x128 only: its sweep is O(N) per ray
    kw = dict(prebuilt=tab_9, pre_ordered=True, tile_mask=mask8,
              **PLAIN_SHAPE)
    mp = in_turns({
        "kernel": lambda i: render_cluster(None, cam9, 2000 + i, **kw),
        "plain": lambda i: render_cluster_reference(None, cam9, 2000 + i,
                                                    **kw)}, 3)
    print(f"[31 timing] K2 tile mask {int(mask8.sum())} of 8 blocks 10k "
          f"spheres 256x128/4spp/d4 (the plain version's shape): kernel "
          f"{mp['kernel']:.4f} ms, plain {mp['plain']:.4f} ms (median of 2x3 "
          f"chained frames each, in turns)")
    k_ms, ev_ms, frame, bnd = k2_share[0.5]
    cluster_mask = {"name": "cluster-tile-mask", "route": "cuda",
                    "source": "tpu_rt_torch/csrc/cluster.cu",
                    "replaces": "tpu_rt/ops/pallas_cluster.py:1565",
                    "launches": cluster_mask_launches,
                    "max_abs_err": cluster_mask_err, "ms": k_ms,
                    "event_ms": ev_ms, "plain_ms": mp["plain"],
                    **bnd, "library_ms": None,
                    "shape": f"10k spheres 1080p/4spp/d4, "
                             f"{int(timed_masks['K2', 0.5].sum())} of "
                             f"{n_bench_tiles} blocks on",
                    "frame_ms": frame,
                    "plain_shape": f"10k spheres 256x128/4spp/d4, "
                                   f"{int(mask8.sum())} of 8 blocks on",
                    "frame_ms_at_plain_shape": mp["kernel"],
                    "share_ms": {f"{s:.0%}": k2_share[s][0] for s in shares}}

    # ================= the display path: denoisers and first-hit AOVs =====
    from tpu_rt_torch.app.denoiser import Denoiser
    from tpu_rt_torch.render.aov import render_aovs
    from tpu_rt_torch.render.display import _apply_method, unpack_grid
    from tpu_rt_torch.render.frame import tone_map
    from tpu_rt_torch.utils.profiling import device_work

    def cpu_copy(t):
        return None if t is None else type(t)(*(f.cpu() for f in t))

    def on_card(label, fn, phase):
        """Device ms, device activities and frame ms per call of ``fn``."""
        ms, n = device_work(fn, 3, device=dev)
        frame = statistics.median(cuda_frame_ms(fn, 3, device=dev))
        print(f"[{phase} timing] {label} on {card}: device {ms:.4f} ms per "
              f"call ({n:.0f} kernels and copies), frame {frame:.4f} ms "
              "(median of 3 chained calls)")
        return {"device_ms": ms, "launches": n, "frame_ms": frame}

    # ---- 32. the GUI's denoiser grid on the main path ----
    methods = ("bilateral", "nlmeans", "gaussian", "median")
    rt = RayTracer(seed=0, device=dev)
    rt.set_scene(demo_api_scene())
    render_megakernel.launches = render_cluster.launches = 0
    acc, total = None, 0
    for _ in range(4):
        batch = rt.render_device(INTERACTIVE["width"], INTERACTIVE["height"],
                                 INTERACTIVE["spp"], INTERACTIVE["max_depth"])
        acc, total = accumulate(acc, total, batch, INTERACTIVE["spp"])
    stacks = {g: display_stack(acc, EXPOSURE, methods=methods, as_uint8=True,
                               grid_scale=g) for g in (2, 1)}
    torch.cuda.synchronize(dev)
    display_launches = render_megakernel.launches
    print(f"[32 display path] RayTracer.render_device x4 at 640x480/8spp/d4 "
          f"-> accumulate -> display_stack(methods={methods}, as_uint8=True, "
          f"grid_scale=2 and 1): stacks {tuple(stacks[2].shape)} and "
          f"{tuple(stacks[1].shape)}; megakernel launches {display_launches},"
          f" cluster launches {render_cluster.launches}")
    check(display_launches == 4, "the display path launched the megakernel "
          "4 times")
    check(tuple(stacks[2].shape) == (3, 480, 640, 3)
          and tuple(stacks[1].shape) == (6, 480, 640, 3), "stack shapes")
    acc_cpu = acc.cpu()
    for g, stack in stacks.items():
        t0 = time.perf_counter()
        plain = display_stack(acc_cpu, EXPOSURE, methods=methods,
                              as_uint8=True, grid_scale=g)
        check(torch.equal(stack[:2].cpu(), plain[:2]),
              f"grid_scale {g}: display and enhanced rows equal the CPU's")
        if g > 1:
            card_rows = unpack_grid(stack[2].cpu(), methods, g)
            cpu_rows = unpack_grid(plain[2].numpy(), methods, g)
        else:
            card_rows = dict(zip(methods, stack[2:].cpu()))
            cpu_rows = dict(zip(methods, plain[2:].numpy()))
        for m in methods:
            a = card_rows[m].int()
            b = torch.from_numpy(np.asarray(cpu_rows[m])).int()
            check(a.shape == b.shape == (480 // g, 640 // g, 3),
                  f"{m} tile shape")
            d = (a - b).abs()
            equal = float((d == 0).float().mean())
            print(f"[32 denoisers vs CPU] grid_scale {g} {m} "
                  f"{tuple(a.shape)}: uint8 max difference {int(d.max())}, "
                  f"equal {equal:.6f}; spread {int(a.max()) - int(a.min())}")
            check(int(a.max()) - int(a.min()) > 64, f"{m}: nonblank")
            if m in ("gaussian", "median"):
                check(int(d.max()) == 0, f"{m} grid_scale {g}: uint8 equal")
            else:
                check(int(d.max()) <= 1 and equal >= 0.999,
                      f"{m} grid_scale {g}: uint8 within 1, 99.9% equal")
        print(f"[32 denoisers vs CPU] grid_scale {g}: the CPU's stack took "
              f"{time.perf_counter() - t0:.1f} s")
    disp = tone_map(acc, EXPOSURE)
    small = disp.reshape(240, 2, 320, 2, 3).mean(dim=(1, 3))
    denoise_ms = {}
    for m in methods:
        for label, img in (("640x480", disp), ("320x240", small)):
            denoise_ms[m, label] = on_card(
                f"{m} {label}", lambda i, m=m, img=img: _apply_method(m, img),
                32)
    for g in (2, 1):
        denoise_ms["display_stack", g] = on_card(
            f"display_stack, 4 methods, grid_scale {g}, uint8",
            lambda i, g=g: display_stack(acc, EXPOSURE, methods=methods,
                                         as_uint8=True, grid_scale=g), 32)

    # ---- 33. first-hit AOVs and the joint denoiser ----
    # render_aovs makes its rays on the scene's device; the card's must be
    # the CPU's, bit for bit (pixel_uv divides by device tensors)
    from tpu_rt_torch.core import camera as cammod

    def rays_on(device, cam_):
        u_, v_ = cammod.pixel_uv(640, 480, None, device=device)
        return u_, v_, cammod.generate_rays(cam_, u_.reshape(-1),
                                            v_.reshape(-1))[1]

    cam_g = cam_for(640, 480)
    card_rays = [t.cpu() for t in rays_on(dev, cam_g)]
    host_rays = rays_on("cpu", cpu_copy(cam_g))
    n_off = [int((a != b).sum()) for a, b in zip(card_rays, host_rays)]
    print(f"[33 rays] made on the card and on the CPU: {n_off[0]} of "
          f"{host_rays[0].numel()} pixel u and {n_off[1]} v coordinates and "
          f"{n_off[2]} of {host_rays[2].numel()} ray direction components "
          "differ")
    check(sum(n_off) == 0, "the card's primary rays equal the CPU's")
    c_acc = render_megakernel(cs, cornell_cam(640, 480), 7, mesh=cm,
                              **CORNELL_ACTIVE, **INTERACTIVE)
    aov_ms = {}
    for label, spheres, mesh, cam_a, img in (
            ("demo scene", scene, None, cam_for(640, 480), disp),
            ("Cornell box", cs, cm, cornell_cam(640, 480),
             tone_map(c_acc, EXPOSURE))):
        a = render_aovs(spheres, cam_a, 640, 480, mesh=mesh)
        b = render_aovs(cpu_copy(spheres), cpu_copy(cam_a), 640, 480,
                        mesh=cpu_copy(mesh))
        same = (a["hit"].cpu() == b["hit"]) & (a["object_id"].cpu()
                                                == b["object_id"])
        share = float(same.float().mean())
        gaps = {k: float((a[k].cpu()[same] - b[k][same]).abs().max())
                for k in ("normal", "albedo")}
        gaps["depth (relative)"] = float(
            ((a["depth"].cpu()[same] - b["depth"][same]).abs()
             / b["depth"][same].abs().clamp_min(1.0)).max())
        print(f"[33 AOVs vs CPU] {label} 640x480: hit and object id equal in "
              f"{share:.6f} of the pixels "
              f"({float(b['hit'].float().mean()):.3f} hit); largest gaps "
              f"where they agree {gaps}")
        check(share >= 0.9999, f"{label} AOVs: hit and object id 99.99%")
        check(max(gaps.values()) <= 1e-5, f"{label} AOVs within 1e-5")
        joint = Denoiser().denoise(img, "joint", aovs=a)
        joint_cpu = Denoiser(device="cpu").denoise(img.cpu(), "joint",
                                                   aovs=b)
        d = np.abs(joint - joint_cpu)
        within = float((d <= 1e-5).mean())
        print(f"[33 joint vs CPU] {label}: max {d.max():.3g}, within 1e-5 "
              f"{within:.6f}")
        check(joint.shape == (480, 640, 3) and bool(np.isfinite(joint).all()),
              f"{label}: joint denoiser output")
        check(d.max() <= 1 / 255 and within >= 0.999,
              f"{label}: joint denoiser on the card vs the CPU")
        aov_ms[label] = on_card(
            f"render_aovs {label} 640x480",
            lambda i, s_=spheres, c_=cam_a, m_=mesh: render_aovs(
                s_, c_, 640, 480, mesh=m_), 33)
        aov_ms["joint " + label] = on_card(
            f"joint bilateral {label} 640x480",
            lambda i, img=img, a=a: Denoiser().denoise(img, "joint", aovs=a),
            33)
    aov_ms["demo scene 320x240"] = on_card(
        "render_aovs demo scene 320x240",
        lambda i: render_aovs(scene, cam_for(320, 240), 320, 240), 33)

    # ---- 34. the cluster walk: vecmath.sqrt on the card, the tie scene,
    # the visit counts against the plain emulation ----
    from tpu_rt_torch.core import vecmath
    from tpu_rt_torch.core.scenes import TIE_CAM, tie_scene

    rng = np.random.default_rng(34)
    xs = np.concatenate([rng.uniform(0.0, 4.0, 1_000_000),
                         np.exp(rng.uniform(-87.0, 88.0, 1_000_000)),
                         [0.0, np.inf, 1e-45, 1e-40]]).astype(np.float32)
    on_card = vecmath.sqrt(torch.from_numpy(xs).to(dev)).cpu()
    n_off = [int((on_card != vecmath.sqrt(torch.from_numpy(xs))).sum()),
             int((on_card.numpy() != np.sqrt(xs)).sum())]
    print(f"[34 sqrt] vecmath.sqrt of {xs.size} f32 values on the card: "
          f"{n_off[0]} differ from the CPU's, {n_off[1]} from numpy's IEEE "
          "sqrt (the kernels' sqrtf)")
    check(n_off == [0, 0], "vecmath.sqrt on the card is IEEE")

    tie_s, tie_m = tie_scene(device=dev)
    cam_tie = tpu_rt_torch.make_camera(**TIE_CAM, device=dev)
    tie_kw = dict(prebuilt=order_clusters(build_clusters(
        tie_s, cluster_size=8), cam_tie.position), tri_prebuilt=order_clusters(
        build_tri_clusters(tie_m, cluster_size=8), cam_tie.position),
        pre_ordered=True, with_stats=True)
    for label, kw in (
            ("one row, depth 1, pixel centres", dict(
                width=256, height=1, spp=1, max_depth=1, jitter=False)),
            ("256x128/4spp/d4", PLAIN_SHAPE),
            ("256x128/4spp/d4, NEE + refraction + stratify", dict(
                PLAIN_SHAPE, nee=True, enable_refraction=True, stratify=True,
                lights=light_table(tie_s)))):
        a, seg_a = render_cluster(None, cam_tie, 7, **tie_kw, **kw)
        b, seg_b = render_cluster_reference(None, cam_tie, 7, **tie_kw, **kw)
        stats = compare(a, b)
        print(f"[34 tie scene] {label}: kernel vs plain {stats}, segments "
              f"{int(seg_a)} vs {int(seg_b)}")
        check_exact(stats, f"tie scene {label}", (seg_a, seg_b))

    def count_case(label, sc, cam_, kw_s, flags):
        kw = dict(with_stats=True, **kw_s, **PLAIN_SHAPE, **flags)
        a, seg_a = render_cluster(sc, cam_, 11, **kw)
        b, seg_b, vis = render_cluster(sc, cam_, 11, with_visits=True, **kw)
        c, seg_c, ref = render_cluster_reference(sc, cam_, 11,
                                                 with_visits=True, **kw)
        n = cluster_mod.N_WALK_COLS
        same = bool(torch.equal(vis[..., :n], ref[..., :n]))
        tot = vis.sum(dim=0).tolist()
        print(f"[34 visit counts] {label} {flag_label(flags)} 256x128/4spp/d4:"
              f" kernel {dict(zip(cluster_mod.VISIT_KINDS, tot))}, equal to "
              f"walk_visits_reference's {same}; counting kernel image equal "
              f"to the timed kernel's and the plain version's "
              f"{bool(torch.equal(a, b) and torch.equal(a, c))}")
        check(same, f"{label} {flag_label(flags)}: visit counts")
        check(torch.equal(a, b) and torch.equal(a, c) and int(seg_a)
              == int(seg_b) == int(seg_c), f"{label}: counting kernel image")

    for label, sc, cam_, kw_s, flags in K2_CASES:
        count_case(label, sc, cam_, kw_s, flags)
    count_case("10k spheres", big, cam9, dict(n_active=BIG["n"]), NEE)
    count_case("100k spheres", huge, cam_for(PLAIN_SHAPE["width"],
                                             PLAIN_SHAPE["height"],
                                             **BIG_CAM),
               dict(n_active=HUGE["n"]), NEE)

    # a frame's samples in chunks (the scratch holds SCRATCH_LANES (lane,
    # sample) threads whatever spp): bit for bit the one-chunk frame's, the
    # gamma mean and the linear one
    chunk_kw = dict(prebuilt=order_clusters(build_clusters(
        big, n_active=BIG["n"]), cam9.position), pre_ordered=True,
        with_stats=True, width=256, height=128, spp=8, max_depth=4, nee=True,
        enable_refraction=True, stratify=True, lights=light_table(big))
    lanes = cluster_mod.SCRATCH_LANES
    for gamma in (True, False):
        kw = dict(chunk_kw, gamma=gamma)
        one, seg_one = render_cluster(None, cam9, 13, **kw)
        plain, seg_plain = render_cluster_reference(None, cam9, 13, **kw)
        try:
            cluster_mod.SCRATCH_LANES = 3 * 8 * cluster_mod.TILE  # 3, 3, 2
            before = render_cluster.launches
            chunked, seg_chunked = render_cluster(None, cam9, 13, **kw)
            n_chunks = render_cluster.launches - before
        finally:
            cluster_mod.SCRATCH_LANES = lanes
        print(f"[34 chunks] 10k spheres NEE + refraction + stratify "
              f"256x128/8spp/d4, gamma {gamma}, in {n_chunks} chunks of at "
              f"most 3 samples: vs one chunk {compare(chunked, one)}, one "
              f"chunk vs plain {compare(one, plain)}; segments "
              f"{int(seg_chunked)} / {int(seg_one)} / {int(seg_plain)}")
        check(n_chunks == 3, "8 samples ran as 3 launches")
        check_exact(compare(chunked, one), f"chunked samples, gamma {gamma}",
                    (seg_chunked, seg_one))
        check_exact(compare(one, plain), f"one chunk vs plain, gamma {gamma}",
                    (seg_one, seg_plain))

    # where a counting build with per-thread counters in registers faulted
    # (100k spheres with NEE), and where a block reduction of the segment
    # counts lost or garbled a warp's count in the timed kernel: the timed
    # kernel twice and the counting kernel agree bit for bit, segments
    # included
    lt_huge = light_table(huge)
    for (w, h, spp_) in ((1920, 1080, 4), (1920, 1024, 4), (1920, 512, 4),
                         (1024, 1080, 4), (640, 480, 8)):
        cam_f = cam_for(w, h, **BIG_CAM)
        kw_f = dict(prebuilt=order_clusters(build_clusters(
            huge, n_active=HUGE["n"]), cam_f.position), pre_ordered=True,
            width=w, height=h, spp=spp_, max_depth=4, with_stats=True,
            nee=True, lights=lt_huge)
        for seed in range(8):
            a, seg_a = render_cluster(None, cam_f, seed, **kw_f)
            a2, seg_a2 = render_cluster(None, cam_f, seed, **kw_f)
            b, seg_b, _ = render_cluster(None, cam_f, seed,
                                         with_visits=True, **kw_f)
            where = f"100k NEE {w}x{h}/{spp_}spp seed {seed}"
            check_exact(compare(a, a2), f"{where}: timed kernel twice",
                        (seg_a, seg_a2))
            check_exact(compare(a, b), f"{where}: counting vs timed kernel",
                        (seg_a, seg_b))
        print(f"[34 fault shapes] 100k spheres NEE {w}x{h}/{spp_}spp/d4, "
              "seeds 0-7: the timed kernel twice and the counting kernel "
              "equal bit for bit, segments included")

    # ---- 35. K1: a lane per (pixel, sample) at spp that do and do not
    # divide a warp (1, 3, 8, 13) or run a second, ragged round of 32-lane
    # groups (33, 40), whole, masked and in a masked band whose last tile
    # is ragged, and at the timed frames, where a lane traces several
    # samples in rounds (640x480/8spp) or holds its pixel alone
    # (1080p/4spp), in every instantiation: the timed kernel, the plain
    # version and the counting kernel bit for bit, segments included, and
    # the counting kernel's per-tile counts equal to
    # megakernel_visits_reference's (the masked frames' plain runs are the
    # whole frames' with the masked tiles zeroed, as the plain version
    # computes them) ----
    t0 = time.perf_counter()
    all_flags = dict(enable_refraction=True, enable_dof=True, stratify=True)
    half = torch.tensor([1, 0, 0, 1, 1, 0, 1, 0], dtype=torch.int32)
    parts = (("whole", {}), ("masked", dict(tile_mask=half)),
             ("masked band", dict(rows=40, row_offset=88,
                                  tile_mask=torch.tensor([1, 0, 1]))))

    def masked_plain(whole, mask, w, h):
        """(image, segments, counts) of render_megakernel_reference(...,
        tile_mask=mask, with_stats=True, with_visits=True) from the whole
        frame's (image, counts): the masked tiles' pixels and counts zeroed
        (the warp column stays the plain version's -1), the segments the
        active tiles' path and shadow segments (no ragged tile)."""
        img, vis = whole
        check(w * h % TILE == 0, "a masked frame of whole tiles")
        on = mask.to(dev) != 0
        img = torch.where(on.repeat_interleave(TILE).reshape(h, w, 1), img,
                          0.0)
        vis = vis.clone()
        vis[~on, :, :3] = 0
        return img, vis[:, :, 0].sum(), vis

    for mesh_on in (False, True):
        sc35, extra = ((bulb, bulb_active) if mesh_on
                       else (scene, dict(n_active=N_ACTIVE)))
        what = "Cornell box + bulb" if mesh_on else "demo scene"
        for fname, fl in (("no flags", {}), ("all flags", all_flags),
                          ("NEE + all flags", dict(nee=True, **all_flags))):
            counted, plain35 = {}, {}
            cases = [(256, 128, spp_, part, more)
                     for spp_ in (1, 3, 8, 13, 33, 40)
                     for part, more in parts]
            cases += [(640, 480, 8, "whole", {}), (1920, 1080, 4, "whole", {})]
            for w35, h35, spp_, part, more in cases:
                kw35 = dict(width=w35, height=h35, spp=spp_, max_depth=4,
                            with_stats=True, **extra, **fl)
                where = f"K1 {what} {fname} {w35}x{h35}/{spp_}spp {part}"
                cam_ = cam_for(w35, h35, aperture=0.1,
                               **(CORNELL_CAM if mesh_on else {}))
                args = (sc35, cam_, 2**31 - 2)
                a, seg_a = render_megakernel(*args, **kw35, **more)
                if part == "masked":
                    # the plain version traces every tile and zeroes the
                    # masked ones (pixels, counts, segments): the whole
                    # frame's plain run, shared
                    b, seg_b, ref = masked_plain(plain35[w35, spp_], half,
                                                 w35, h35)
                else:
                    b, seg_b, ref = render_megakernel_reference(
                        *args, with_visits=True, **kw35, **more)
                if part == "whole":
                    plain35[w35, spp_] = (b, ref)
                c, seg_c, vis = render_megakernel(
                    *args, with_visits=True, **kw35, **more)
                check_exact(compare(a, b), f"{where}: kernel vs plain",
                            (seg_a, seg_b))
                check_exact(compare(c, a), f"{where}: counting vs timed",
                            (seg_c, seg_a))
                check(torch.equal(vis[..., :3], ref[..., :3]),
                      f"{where}: counts {vis.sum(0).tolist()} vs "
                      f"megakernel_visits_reference's "
                      f"{ref.sum(0).tolist()}")
                tests = int(vis[..., 1:3].sum())
                warps = int(vis[..., 3].sum())
                check(warps <= tests <= 32 * warps,
                      f"{where}: warps issue 1 to 32 lanes a test")
                counted[w35, spp_, part] = vis.sum(0).tolist()
            v8 = counted[256, 8, "whole"]
            lanes8 = ((v8[0][1] + v8[0][2] + v8[1][1] + v8[1][2])
                      / max(v8[0][3] + v8[1][3], 1))
            print(f"[35 K1 counts] {what}, {fname}: 256x128 at spp 1, 3, 8, "
                  "13, 33, 40, whole, masked and in a masked band, and "
                  "640x480/8spp and 1080p/4spp: kernel, plain and counting "
                  "kernel bit for bit, counts equal "
                  "megakernel_visits_reference's; at 256x128/8spp whole: "
                  f"path {v8[0][:3]}, shadow {v8[1][:3]} (segments, sphere "
                  f"tests, triangle tests), {lanes8:.1f} lanes per "
                  "warp-issued test")
    print(f"[35 K1 counts] {time.perf_counter() - t0:.1f} s")

    # ---- 36. the interactive app on the card ----
    app_phase(dev, card)

    # ---- 37. the lax engine on the card ----
    lax_phase(dev, card)

    # ---- 38. the parallel layer on the card ----
    parallel_phase(dev, card)

    mega["name"] = "megakernel-spheres"
    print(f"[39 done] all phases passed in {time.perf_counter() - t_start:.1f}"
          " s")
    kernels = [mega, mega_tri, cluster, cluster_tri, mega_flags,
               cluster_flags, mega_nee, cluster_nee, mega_mask, cluster_mask,
               fma_entry]
    for e in kernels:
        check(e["ms"] >= e["bound_ms"], f"{e['name']}: {e['ms']:.4f} ms is "
              f"no less than its bound {e['bound_ms']:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
