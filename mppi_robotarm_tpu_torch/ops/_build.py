"""Build and load the port's CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, ``build/torch_kernels/libmppi_kernels.so`` at the
root of the checkout, which ``ctypes`` loads.  A digest of the sources and
flags sits beside the library, so an edit to a source rebuilds it.  The
build reports ``ptxas``'s figures (registers, shared memory, spills).
Nothing here runs at import: the CPU tests import every module and have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libmppi_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",          # keep a*b+c rounded twice, as the torch twin does
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> str:
    """Compile the kernels unless the library is current; return nvcc's
    report ("" when nothing was built).  Raises if nvcc fails."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = _digest(sources + sorted(_CSRC.glob("*.cuh")))
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed (printing nvcc's report to standard error), load the
    library and declare its C functions."""
    print(build(), file=sys.stderr, end="")
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    ptr = ctypes.c_void_p
    lib.mppi_sim_launch.argtypes = [ptr, ctypes.c_int] + [ptr] * 9
    lib.mppi_sim_launch.restype = ctypes.c_int
    lib.mppi_error_string.argtypes = [ctypes.c_int]
    lib.mppi_error_string.restype = ctypes.c_char_p
    return lib
