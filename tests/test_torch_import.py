"""tpu_rt_torch imports with jax blocked, never imports tpu_rt, and never
falls back to the CPU: a missing GPU raises, a failed build raises, and
chip_smoke.py fails without CUDA or without the repository beside it."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_rt_torch
from tpu_rt_torch.kernels import build
from tpu_rt_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent

SLICE_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(tpu_rt_torch.__path__,
                                          "tpu_rt_torch."))

BLOCKED_IMPORT = """
import sys
sys.modules["jax"] = None
sys.modules["tpu_rt"] = None
import importlib
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "tpu_rt")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok", len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax():
    assert {"tpu_rt_torch.ops.megakernel", "tpu_rt_torch.api.compat",
            "tpu_rt_torch.app.run", "tpu_rt_torch.kernels.build",
            "tpu_rt_torch.utils.profiling", "tpu_rt_torch.ops.triangle",
            "tpu_rt_torch.core.scenes", "tpu_rt_torch.utils.objio",
            "tpu_rt_torch.utils.convert", "tpu_rt_torch.utils.roofline",
            "tpu_rt_torch.ops.post", "tpu_rt_torch.app.denoiser",
            "tpu_rt_torch.render.aov", "tpu_rt_torch.app.interaction",
            "tpu_rt_torch.app.gui", "tpu_rt_torch.app.panel_logic",
            "tpu_rt_torch.app.preview", "tpu_rt_torch.app.utils",
            "tpu_rt_torch.utils.checkpoint",
            "tpu_rt_torch.utils.config", "tpu_rt_torch.core.rng",
            "tpu_rt_torch.ops.integrator", "tpu_rt_torch.ops.bvh",
            "tpu_rt_torch.native", "tpu_rt_torch.parallel",
            "tpu_rt_torch.parallel.mesh",
            "tpu_rt_torch.parallel.multihost"} <= set(SLICE_MODULES)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT, *SLICE_MODULES],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"ok {len(SLICE_MODULES)}"


def test_no_source_mentions_jax_imports():
    for path in (ROOT / "tpu_rt_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from tpu_rt." not in text and "import tpu_rt\n" not in text


def test_raytracer_on_missing_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tpu_rt_torch.api import RayTracer

    with pytest.raises(RuntimeError, match="CUDA"):
        RayTracer(device="cuda")


def test_cuda_timer_refuses_cpu():
    with pytest.raises(RuntimeError):
        profiling.cuda_frame_ms(lambda i: None, 3, device="cpu")
    with pytest.raises(RuntimeError):
        profiling.device_ms_by_kernel(lambda i: None, 3, device="cpu")
    with pytest.raises(RuntimeError):
        profiling.device_work(lambda i: None, 3, device="cpu")
    with pytest.raises(RuntimeError):
        profiling.launch_ms(lambda i: None, "k", 3, device="cpu")
    assert profiling.traced_mrays_per_s(2_000_000, 2.0) == 1000.0


def test_build_without_nvcc_raises():
    if (shutil.which("nvcc") or os.environ.get("CUDA_HOME")
            or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("a CUDA toolkit is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_library_name_follows_sources_and_flags(monkeypatch, tmp_path):
    first = build.library_path()
    assert first == build.library_path()
    assert first.parent == build.BUILD_DIR
    assert [s.name for s in build.sources()] == ["cluster.cu", "fma.cu",
                                                 "megakernel.cu"]
    assert [h.name for h in build.headers()] == ["path_common.cuh"]
    # a copy of the sources names the same library; a changed header or
    # source names another, so the next load builds anew
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.library_path() == first
    header = csrc / "path_common.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    assert build.library_path() != first
    shutil.copy(ROOT / "tpu_rt_torch" / "csrc" / "path_common.cuh", header)
    assert build.library_path() == first
    (csrc / "cluster.cu").write_text("// changed\n")
    assert build.library_path() != first
    monkeypatch.setattr(build, "CSRC", ROOT / "tpu_rt_torch" / "csrc")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-DX=1"])
    assert build.library_path() != first


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
