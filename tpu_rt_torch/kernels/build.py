"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``tpu_rt_torch/csrc/*.cu`` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):
one compiler process per source, all started together, then one link.
The library lands in ``build/tpu_rt_torch/`` beside the package, named by a
hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags: a changed file builds anew, an unchanged tree is reused. The linker
writes to a temporary file that is renamed into place, so concurrent
processes never load a half-written library.

Fast-math is never used: the kernels rely on IEEE NaN compares. Nor is
multiply-add contraction (``--fmad=false``): every product and sum rounds
as in the plain PyTorch versions, so a kernel and its plain version agree
bit for bit on the card. (Contracted FMAs round hit points differently by
an ulp, which turns a fraction of a percent of paths at silhouettes.) The
FMA microkernel (``csrc/fma.cu``) writes its FMAs as ``__fmaf_rn``
intrinsics, which the flag leaves whole.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_rt_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false", "-Xptxas",
                           "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types of each exported C function
SIGNATURES = {
    "tpurt_megakernel_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I,
                                _P, _P, _P],
    "tpurt_cluster_launch": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I,
                             _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                             _P, _P, _P, _P],
    "tpurt_fma_launch": [_P, _P, _I, _I, _P],
    "tpurt_fma_device": [_I, _P, _P, _P],
}


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then /usr/local/cuda, then
    PATH. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of tpu_rt_torch "
                           "build on a machine with the CUDA toolkit")
    return found


def sources() -> list[Path]:
    """The compiled sources, one object each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    """The headers the sources include."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpurt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (command, process); raise with the compiler's output
    if one failed. Returns the collected output."""
    log, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(log)


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path. The compiler's report (registers, spills) is kept beside it as
    ``.log``. Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources()]
        compiles = []
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = _run(compiles)
        lib = Path(tmp) / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
               *(str(o) for o in objs)]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))])
        out.with_suffix(".log").write_text(log)
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptxas_lines(log: str) -> list[str]:
    """The megakernel instantiations' registers and spills from the ptxas
    report that :func:`build` keeps beside the library: one line
    '<kTris, kFlags, kNee, kCount>: N registers; <its spill line>' each."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "megakernel" in m.group(1) else None
            spill = ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{demangle(entry)}: {regs.group(1)} registers; "
                       f"{spill}")
            entry = None
    return out


def demangle(entry: str) -> str:
    """The template arguments of a mangled megakernel instantiation."""
    args = re.search(r"megakernel.*?I(L?b[01]E)+", entry)
    if not args:
        return entry
    return "<" + ", ".join(re.findall(r"b([01])E", args.group(0))) + ">"
