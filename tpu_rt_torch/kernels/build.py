"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``tpu_rt_torch/csrc/*.cu`` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in ``build/tpu_rt_torch/`` beside the package, named by a
hash of the sources and flags: a changed source builds anew, an unchanged
one is reused. The compiler writes to a temporary file that is renamed into
place, so concurrent processes never load a half-written library.

Fast-math is never used: the kernels rely on IEEE NaN compares.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpu_rt_torch"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                           "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types of each exported C function
SIGNATURES = {
    "tpurt_megakernel_launch": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P, _I, _P, _P],
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
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpurt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path. The compiler's report (registers, spills) is kept beside it as
    ``.log``. Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *(str(s) for s in sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
