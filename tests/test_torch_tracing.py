"""The port's own spans and upload counter (``tpu_rt_torch/utils/
profiling.py``) on the CPU, and the benchmark's readers of them
(``rtbench/metrics/``).

A span is entered only while a profiler records; under one, the camera
upload of ``RayTracer.render_device`` lies directly under the benchmark's
``rtbench.render_device`` range with its batch number, the cluster tables'
order only on a camera move, and the first batch of every camera pose
copies the same number of host arrays to the device, a batch that repeats
its pose none. The wrappers' ``prepare`` and ``launch`` spans run on the
card only (``tests/test_torch_gpu.py``).
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtbench import spec, trace
from tpu_rt_torch.api import Material, RayTracer, Scene, Sphere, Vector3
from tpu_rt_torch.app.interaction import SceneManager
from tpu_rt_torch.core.scenes import random_spheres
from tpu_rt_torch.utils import profiling

CPU = torch.device("cpu")
torch.set_num_threads(1)
SHAPE = (32, 32, 1, 2)  # width, height, spp, depth
# the uploads of a pose's first batch: make_camera's seven host_tensor
# copies and basis's two constants (the same for both engines, with NEE or
# without); a batch that repeats its pose uploads nothing
UPLOADS_PER_BATCH = 9


def _field(n=100):
    """An api Scene of ``n`` random spheres: past 64, the cluster engine."""
    arrays = random_spheres(n, seed=3, spread=4.0, device=CPU)
    scene = Scene()
    for i in range(n):
        s = Sphere()
        s.center = Vector3(*map(float, arrays.center[i]))
        s.radius = float(arrays.radius[i])
        m = Material()
        m.albedo = Vector3(*map(float, arrays.albedo[i]))
        m.metallic = float(arrays.metallic[i])
        m.roughness = float(arrays.roughness[i])
        m.emission = Vector3(*map(float, arrays.emission[i]))
        s.material = m
        s.object_id = i
        scene.add_sphere(s)
    return scene


def _tracer(engine, nee=False):
    rt = RayTracer(seed=5, nee=nee, device=CPU)
    rt.set_scene(SceneManager.create_interactive_scene()
                 if engine == "pallas" else _field())
    return rt


def _traced_batches(rt, n):
    """``n`` batches of ``rt`` under a CPU profiler that records shapes,
    each inside the benchmark's ``rtbench.render_device`` range, in its
    window; returns the profiler."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with trace.span(trace.WINDOW, True):
            for _ in range(n):
                with trace.span("rtbench.render_device", True):
                    rt.render_device(*SHAPE)
    return prof


def _port_events(prof):
    """(name, batch, start, end) of the port's spans, in time order."""
    return sorted(((ev.name(), ev.kwinputs().get("batch"), ev.start_ns(),
                    ev.end_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith(profiling.SPAN_PREFIX)),
                  key=lambda x: x[2])


def test_span_is_a_shared_null_context_when_no_profiler_records():
    assert not torch.autograd._profiler_enabled()
    null = profiling.span("camera", 7)
    assert null is profiling.span("prepare")
    before = profiling.counts(traced=True)
    with null as entered:
        assert entered is None
    assert profiling.counts(traced=True) == before


def test_camera_span_lies_under_the_benchmark_span_with_its_batch():
    rt = _tracer("pallas")
    rt.render_device(*SHAPE)  # batch 0, untraced
    prof = _traced_batches(rt, 2)
    tl = trace.read(prof)
    cams = [(s, e) for parent, op, s, e in tl.ops
            if op == "tpu_rt_torch.camera"]
    assert len(cams) == 2
    assert all(parent == "rtbench.render_device" for parent, op, _, _
               in tl.ops if op.startswith(profiling.SPAN_PREFIX))
    assert [(n, b) for n, b, _, _ in _port_events(prof)] == [
        ("tpu_rt_torch.camera", 1), ("tpu_rt_torch.camera", 2)]
    # the spans are flat: none begins before the last one ended
    events = _port_events(prof)
    assert all(a[3] <= b[2] for a, b in zip(events, events[1:]))


def test_torch_trace_writes_the_spans_with_their_batch(tmp_path):
    rt = _tracer("pallas")
    with profiling.torch_trace(str(tmp_path)):
        rt.render_device(*SHAPE)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    cams = [e for e in events if e.get("name") == "tpu_rt_torch.camera"]
    assert len(cams) == 1 and cams[0]["args"]["batch"] == 0


def test_order_span_on_the_first_batch_of_a_camera_position_only():
    rt = _tracer("cluster")
    prof = _traced_batches(rt, 2)
    events = [(n, b) for n, b, _, _ in _port_events(prof)]
    assert events == [("tpu_rt_torch.camera", 0), ("tpu_rt_torch.order", 0),
                      ("tpu_rt_torch.camera", 1)]
    cam = rt.get_camera()
    cam.position = Vector3(0.5, 2.0, 5.0)
    rt.set_camera(cam)
    prof = _traced_batches(rt, 1)
    assert [n for n, _, _, _ in _port_events(prof)] == [
        "tpu_rt_torch.camera", "tpu_rt_torch.order"]


@pytest.mark.parametrize("engine, nee", [("pallas", False), ("pallas", True),
                                         ("cluster", False)])
def test_uploads_per_batch_are_equal_and_pinned(engine, nee):
    rt = _tracer(engine, nee)
    per_batch = []
    for moved in (False, False, False, True, False):
        if moved:
            rt.move_camera(Vector3(0.25, 0.0, 0.0))
        before = profiling.counts().get("uploads", 0)
        rt.render_device(*SHAPE)
        per_batch.append(profiling.counts()["uploads"] - before)
    assert per_batch == [UPLOADS_PER_BATCH, 0, 0, UPLOADS_PER_BATCH, 0]


def test_traced_counts_are_kept_apart_and_cleared_by_the_next_profiler():
    name = "test_tracing.counter"
    profiling.count(name)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count(name, 2)
        assert profiling.counts(traced=True)[name] == 2
    profiling.count(name)  # after the window: not a traced count
    assert profiling.counts(traced=True)[name] == 2
    assert profiling.counts()[name] == 4
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("camera", 0):
            pass
        assert name not in profiling.counts(traced=True)
        profiling.count(name, 5)
    assert profiling.counts(traced=True)[name] == 5
    assert profiling.counts()[name] == 9


def _timeline():
    """Two batches of 4 ms on the device; the host is in each batch's
    camera span (0.5 ms, idle through 0.4 ms of it), its prepare span
    (0.3 ms) and its launch span (0.1 ms) before the kernel starts."""
    tl = trace.Timeline(start=0.0, end=10000.0)
    for b, t in enumerate((1000.0, 6000.0)):
        tl.device.append(("void megakernel<false, false, false, false>",
                          t, t + 4000.0))
        tl.spans.append(("rtbench.render_device", t - 1000.0, t + 100.0))
        tl.ops += [("rtbench.render_device", "tpu_rt_torch.camera",
                    t - 1000.0, t - 500.0),
                   ("rtbench.render_device", "aten::mul", t - 450.0,
                    t - 420.0),
                   ("rtbench.render_device", "tpu_rt_torch.prepare",
                    t - 400.0, t - 100.0),
                   ("rtbench.render_device", "tpu_rt_torch.launch",
                    t - 100.0, t + 50.0)]
    # the copy that keeps the device busy through 0.1 ms of batch 0's camera
    tl.device.append(("Memcpy HtoD (Pageable -> Device)", 50.0, 150.0))
    return tl


def _readings(**kw):
    from types import SimpleNamespace

    base = dict(timeline=_timeline(), batches_traced=2, enqueue_s=[],
                ops_per_batch=0.0, bytes_per_batch=0.0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_span_readers_on_a_known_timeline():
    r = _readings()
    read = {m: spec.reader(m)(r) for m in ("camera_ms", "prepare_ms",
                                           "program_idle_ms")}
    assert read["camera_ms"] == pytest.approx(0.5)
    assert read["prepare_ms"] == pytest.approx(0.3)
    # idle inside the spans: batch 0 0.4 + 0.3 + 0.1 ms, batch 1 0.5 + 0.3
    # + 0.1 ms (the launch span's last 0.05 ms overlap the kernel)
    assert read["program_idle_ms"] == pytest.approx((0.8 + 0.9) / 2)
    for m in read:
        assert spec.reader(m)(_readings(timeline=None)) is None
        assert spec.reader(m)(_readings(batches_traced=0)) is None
    # a program without the spans (the benchmark's own alone)
    bare = _timeline()
    bare.ops = [op for op in bare.ops if op[1] == "aten::mul"]
    for m in read:
        assert spec.reader(m)(_readings(timeline=bare)) is None
    # the breakdown labels a gap by the host's activity at its midpoint
    idle = dict(trace.breakdown(_timeline())["idle_gaps"])
    assert idle["render_device/tpu_rt_torch.camera"] == pytest.approx(0.00105)
    assert idle["render_device/aten::mul"] == pytest.approx(0.00085)


def test_uploads_reader_reads_the_traced_count(monkeypatch):
    read = spec.reader("uploads_per_batch")
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("uploads", 2 * UPLOADS_PER_BATCH)
    assert read(_readings()) == UPLOADS_PER_BATCH
    assert read(_readings(batches_traced=0)) is None
    assert read(_readings(timeline=None)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("not uploads")
    assert read(_readings()) is None
    # a program without the counter
    monkeypatch.delattr(profiling, "counts")
    assert read(_readings()) is None
