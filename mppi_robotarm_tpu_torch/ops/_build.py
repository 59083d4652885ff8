"""Build and load the port's CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared library
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3",
    "--fmad=false",          # keep a*b+c rounded twice, as the torch twin does
    "-Xcompiler", "-fPIC",
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


def _run_all(cmds):
    """Run the commands at the same time; raise on the first that fails.
    Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


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
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", "-o",
                     str(obj), str(src)] for src, obj in zip(sources, objs)])
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return log


def _check_abi(lib, fn: str, struct) -> None:
    size = getattr(lib, fn)()
    if size != ctypes.sizeof(struct):
        raise RuntimeError(f"{struct.__name__} mirrors {size} bytes of C "
                           f"struct as {ctypes.sizeof(struct)}: the ctypes "
                           f"fields and the kernel's struct differ")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed (printing nvcc's report to standard error), load the
    library, declare its C functions and check that each parameter struct
    has the size of its ctypes mirror."""
    from .cuda_sim import _SimParams
    from .cuda_solve import _SolveParams

    print(build(), file=sys.stderr, end="")
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    ptr = ctypes.c_void_p
    lib.mppi_sim_launch.argtypes = [ptr, ctypes.c_int] + [ptr] * 9
    lib.mppi_sim_launch.restype = ctypes.c_int
    lib.mppi_solve_launch.argtypes = [ptr, ctypes.c_int] + [ptr] * 14
    lib.mppi_solve_launch.restype = ctypes.c_int
    lib.mppi_fleet_launch.argtypes = [ptr] + [ctypes.c_int] * 2 + [ptr] * 9
    lib.mppi_fleet_launch.restype = ctypes.c_int
    lib.mppi_fleet_scratch_floats.argtypes = [ptr]
    lib.mppi_fleet_scratch_floats.restype = ctypes.c_int
    lib.mppi_probe_scale_launch.argtypes = [ptr, ptr, ctypes.c_int, ptr]
    lib.mppi_probe_scale_launch.restype = ctypes.c_int
    lib.mppi_probe_big_launch.argtypes = [ptr, ptr, ctypes.c_int, ptr,
                                          ctypes.c_int, ptr]
    lib.mppi_probe_big_launch.restype = ctypes.c_int
    lib.mppi_error_string.argtypes = [ctypes.c_int]
    lib.mppi_error_string.restype = ctypes.c_char_p
    for fn in ("mppi_sim_params_size", "mppi_solve_params_size"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = ctypes.c_int
    _check_abi(lib, "mppi_sim_params_size", _SimParams)
    _check_abi(lib, "mppi_solve_params_size", _SolveParams)
    return lib
