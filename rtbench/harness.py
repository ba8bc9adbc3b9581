"""One run of a cell: set-up, the measured window and what it produced.

The window drives the batch pipeline of the reference GUI's render worker
from the benchmark's own loop, without its thread and sleeps:
``RayTracer.render_device`` -> ``render.frame.accumulate`` ->
``render.display.display_stack(acc, exposure, as_uint8=True)`` pulled to
the host, with ``RayTracer.set_camera`` before each view of a ``view``
mix. A configuration's triangle mesh is built with
``ops/triangle.py:make_mesh`` and handed to ``RayTracer.set_mesh`` before
the first batch. The program is imported when a run starts, never when
this module is.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from . import reference, roofline, scenes, trace
from .spec import Cell
from .traffic import Plan


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Unit:
    """A still or a view the window produced: its RayTracer frames, its
    camera, the accumulator, the last display it pulled and the sample
    count the accumulation returned."""

    index: int
    frames: range
    camera: dict
    acc: object
    display: np.ndarray
    samples: int
    tiles: list = field(default_factory=list)


@dataclass
class Window:
    seconds: float = 0.0
    batches: int = 0
    samples: int = 0
    units: int = 0
    first_s: list = field(default_factory=list)
    view_s: list = field(default_factory=list)
    enqueue_s: list = field(default_factory=list)   # outside the trace
    batches_traced: int = 0
    timeline: object = None
    launches: tuple = (0, 0)
    kept: list = field(default_factory=list)


class Reservoir:
    """A uniform sample of ``k`` of the offered units, drawn from ``rng``:
    ``slot()`` says where the next unit goes (None: nowhere), before it is
    made."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def slot(self):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


def build_mesh(mesh: dict, device):
    """The program's TriangleMesh (``ops/triangle.py:make_mesh``) of a
    recipe's faces (``scenes.MESH_FIELDS``) on ``device``: face f is
    vertices 3f, 3f + 1, 3f + 2, with its own materials."""
    from tpu_rt_torch.ops.triangle import make_mesh

    verts = mesh["vertices"]
    f = verts.shape[0]
    return make_mesh(verts.reshape(-1, 3), np.arange(3 * f).reshape(f, 3),
                     albedo=mesh["albedo"], metallic=mesh["metallic"],
                     roughness=mesh["roughness"], emission=mesh["emission"],
                     ior=mesh["ior"], object_id=mesh["object_id"],
                     device=device)


class Program:
    """The system under test, one RayTracer on one device."""

    def __init__(self, cell: Cell, plan: Plan, device):
        from tpu_rt_torch.api import compat as api
        from tpu_rt_torch.ops import cluster, megakernel
        from tpu_rt_torch.render import display, frame

        self.api, self.frame, self.display = api, frame, display
        self.kernels = (megakernel.render_megakernel, cluster.render_cluster)
        self.traffic, self.device, self.plan = plan.traffic, device, plan
        arrays = scenes.scene_arrays(cell.config)
        self.scene = self._scene(arrays)
        self.mesh, self.n_tris, self.n_tri_active = None, 0, None
        if arrays["mesh"] is not None:
            self.mesh = build_mesh(arrays["mesh"], device)
            self.n_tris = int(arrays["mesh"]["vertices"].shape[0])
            self.n_tri_active = frame.quantize_count(self.n_tris,
                                                     self.mesh.capacity)
        self.rt = api.RayTracer(seed=plan.tracer_seed,
                                nee=bool(self.traffic["nee"]), device=device)
        self.rt.set_scene(self.scene)
        if self.mesh is not None:
            self.rt.set_mesh(self.mesh)
        self.rt.set_camera(self.camera(plan.camera(0)))
        self.frames = 0  # render_device calls so far
        self._host = None  # the pulled display, reused

    def _scene(self, arrays):
        api = self.api
        scene = api.Scene()
        scene.background_color = api.Vector3(*map(float,
                                                  arrays["background"]))
        for i in range(arrays["radius"].shape[0]):
            s = api.Sphere()
            s.center = api.Vector3(*map(float, arrays["center"][i]))
            s.radius = float(arrays["radius"][i])
            m = api.Material()
            m.albedo = api.Vector3(*map(float, arrays["albedo"][i]))
            m.metallic = float(arrays["metallic"][i])
            m.roughness = float(arrays["roughness"][i])
            m.emission = api.Vector3(*map(float, arrays["emission"][i]))
            m.ior = float(arrays["ior"][i])
            s.material = m
            s.object_id = i
            scene.add_sphere(s)
        return scene

    def camera(self, cam: dict):
        api = self.api
        c = api.Camera()
        c.position = api.Vector3(*map(float, cam["position"]))
        c.target = api.Vector3(*map(float, cam["target"]))
        c.up = api.Vector3(*map(float, cam["up"]))
        c.fov = float(cam["fov"])
        return c

    def batch(self, acc, n, tracing: bool):
        tr = self.traffic
        with trace.span("rtbench.render_device", tracing):
            img = self.rt.render_device(tr["width"], tr["height"], tr["spp"],
                                        tr["max_depth"])
        with trace.span("rtbench.accumulate", tracing):
            acc, n = self.frame.accumulate(acc, n, img, tr["spp"])
        self.frames += 1
        return acc, n

    def pull(self, acc, tracing: bool) -> np.ndarray:
        """The display stack, copied into one page-locked host buffer that
        every pull reuses (a view of it is returned)."""
        import torch

        with trace.span("rtbench.display_stack", tracing):
            stack = self.display.display_stack(acc, self.traffic["exposure"],
                                               as_uint8=True)
        with trace.span("rtbench.pull", tracing):
            if self._host is None or self._host.shape != stack.shape:
                self._host = torch.empty(
                    stack.shape, dtype=stack.dtype,
                    pin_memory=stack.device.type == "cuda")
            self._host.copy_(stack)
            return self._host.numpy()

    def launches(self) -> tuple:
        return tuple(k.launches for k in self.kernels)

    def segments(self, frame: int, cam: dict, tile_mask=None) -> int:
        """The program's own count of the segments that RayTracer batch
        ``frame`` at camera ``cam`` traces (over the tiles of
        ``tile_mask``), by its counting call, with the RayTracer's scene
        and mesh."""
        tr = self.traffic
        arrays = self.scene.to_arrays(device=self.device)
        c = self.camera(cam)
        c.aspect_ratio = tr["width"] / tr["height"]
        n_active = self.frame.quantize_count(len(self.scene.spheres),
                                             arrays.capacity)
        _, segs = self.frame.render(
            arrays, c.to_params(self.device),
            reference.batch_seed(self.plan.tracer_seed, frame),
            width=tr["width"], height=tr["height"], spp=tr["spp"],
            max_depth=tr["max_depth"], with_stats=True, n_active=n_active,
            nee=bool(tr["nee"]), enable_dof=False, tile_mask=tile_mask,
            mesh=self.mesh, n_tri_active=self.n_tri_active)
        return int(segs)


def run_units(prog: Program, plan: Plan, first: int, count: int) -> None:
    """Units ``first`` .. ``first + count - 1``, untimed (the warm-up)."""
    for u in range(first, first + count):
        if plan.kind == "view":
            prog.rt.set_camera(prog.camera(plan.camera(u)))
        acc, n = None, 0
        for b in range(plan.traffic["batches_per_unit"]):
            acc, n = prog.batch(acc, n, False)
            if (b + 1) % plan.traffic["pull_every"] == 0:
                prog.pull(acc, False)
    _sync(prog.device)


def window(prog: Program, plan: Plan, seconds: float, trace_on: bool,
           first_unit: int) -> Window:
    """The measured window: units from ``first_unit`` until ``seconds``
    have passed. A still that the close cuts is finished after it,
    untimed; views are whole. With ``trace_on`` a profiler records the
    first ``trace_seconds`` of it."""
    tr = plan.traffic
    B, every, view = tr["batches_per_unit"], tr["pull_every"], plan.kind == "view"
    w = Window()
    keep = Reservoir(tr["check"]["units"], plan.check_rng)
    launches0 = prog.launches()
    prof = trace.profiler() if trace_on else None
    rng_window = None
    if prof is not None:
        rng_window = trace.span(trace.WINDOW, True)
        rng_window.__enter__()
    tracing = prof is not None
    closed = False
    t_start = time.perf_counter()
    deadline = t_start + seconds

    def stop_trace():
        # the profiler's stop takes seconds; the window is lengthened by
        # it, so the untraced part keeps its length
        nonlocal tracing, deadline
        _sync(prog.device)
        rng_window.__exit__(None, None, None)
        t = time.perf_counter()
        prof.stop()
        deadline += time.perf_counter() - t
        tracing = False

    def close():
        nonlocal closed
        if tracing:
            stop_trace()
        _sync(prog.device)
        w.seconds = time.perf_counter() - t_start
        w.launches = tuple(b - a for a, b in zip(launches0, prog.launches()))
        closed = True

    u = first_unit
    while not closed:
        if time.perf_counter() >= deadline:
            close()
            break
        cam = plan.camera(u)
        cam_obj = prog.camera(cam) if view else None
        frame0 = prog.frames
        t0 = time.perf_counter()
        if view:
            with trace.span("rtbench.set_camera", tracing):
                prog.rt.set_camera(cam_obj)
        acc, n, first_s, disp = None, 0, None, None
        for b in range(B):
            if not view and not closed and b and time.perf_counter() >= deadline:
                close()
            ts = time.perf_counter()
            acc, n = prog.batch(acc, n, tracing)
            if not closed:
                w.batches += 1
                w.samples += tr["width"] * tr["height"] * tr["spp"]
                if tracing:
                    w.batches_traced += 1
                else:
                    w.enqueue_s.append(time.perf_counter() - ts)
            if (b + 1) % every == 0:
                disp = prog.pull(acc, tracing)
                if first_s is None:
                    first_s = time.perf_counter() - t0
            if tracing and time.perf_counter() - t_start >= tr["trace_seconds"]:
                stop_trace()
        if not closed:
            w.units += 1
            if view:
                w.first_s.append(first_s)
                w.view_s.append(time.perf_counter() - t0)
        slot = keep.slot()
        if slot is not None:
            keep.items[slot] = Unit(u, range(frame0, prog.frames), cam, acc,
                                    disp.copy(), n)
        u += 1
    _sync(prog.device)
    w.kept = keep.items
    if prof is not None:
        w.timeline = trace.read(prof)
    return w


@dataclass
class Run:
    """Everything one run measured, before the comparison."""

    setup_s: float
    window: Window
    memory_peak_bytes: int
    ops_per_batch: float
    bytes_per_batch: float
    port_segments: int       # the counting call over the checked tiles
    device_kind: str
    device_count: int
    setup_stamps: list      # (phase, seconds since the process started)


def measure(cell: Cell, seed: int, seconds: float, trace_on: bool,
            device, t_process: float, fault=None) -> tuple[Run, Plan]:
    """Set up, warm up and measure one run of ``cell``; ``t_process`` is
    the host time the process started at. ``fault``, a function of the
    Program, breaks the timed path after the warm-up (the checks of the
    comparison use it)."""
    import torch

    stamps = [("start", time.perf_counter() - t_process)]
    plan = Plan(cell.traffic, cell.config, seed)
    tr = plan.traffic
    prog = Program(cell, plan, device)
    stamps.append(("scene", time.perf_counter() - t_process))
    warm = tr["warmup_units"]
    run_units(prog, plan, 0, warm)
    stamps.append(("warm-up", time.perf_counter() - t_process))
    # the program's own count of a batch's segments, for the rooflines
    segs = prog.segments(prog.frames, plan.camera(warm))
    n_pix = tr["width"] * tr["height"]
    n_spheres, n_tris = len(prog.scene.spheres), prog.n_tris
    ops = roofline.batch_ops(segs, n_pix, tr["spp"], n_spheres,
                             bool(tr["nee"]), n_tris)
    nbytes = roofline.batch_bytes(n_pix, n_spheres, n_tris)
    setup_s = time.perf_counter() - t_process
    if fault is not None:
        fault(prog)

    w = window(prog, plan, seconds, trace_on, warm)

    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    engine = cell.config["engine"]
    n_tiles, _ = reference.tile_grid(engine, tr["width"], tr["height"])
    sc = reference.Scene(scenes.scene_arrays(cell.config), engine, device)
    for unit in w.kept:
        cam = reference.pack_camera(unit.camera, tr["width"] / tr["height"],
                                    device)
        shown = reference.varying_tiles(
            sc, cam, engine, reference.batch_seed(plan.tracer_seed,
                                                  unit.frames[0]),
            width=tr["width"], height=tr["height"],
            max_depth=tr["max_depth"], nee=bool(tr["nee"]))
        unit.tiles = sorted(int(t) for t in plan.check_rng.choice(
            shown, size=min(len(shown), tr["check"]["tiles"]),
            replace=False))
    del sc
    port_segments = -1
    if w.kept:
        mask = np.zeros((n_tiles,), np.int32)
        mask[w.kept[0].tiles] = 1
        port_segments = prog.segments(w.kept[0].frames[0], w.kept[0].camera,
                                      tile_mask=mask)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    count = 1
    del prog
    if cuda:
        torch.cuda.empty_cache()
    return Run(setup_s, w, peak, ops, nbytes, port_segments, kind,
               count, stamps), plan
