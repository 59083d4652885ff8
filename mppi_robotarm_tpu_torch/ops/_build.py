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


_P, _I = ctypes.c_void_p, ctypes.c_int

# (argtypes, restype) of each C function of the library, in the order of
# its declaration in csrc/: c_void_p for every pointer and the stream,
# c_int for every int.
C_FUNCTIONS = {
    "mppi_sim_launch": ([_P, _I, _I] + [_P] * 9, _I),
    "mppi_solve_launch": ([_P, _I] + [_P] * 14, _I),
    "mppi_fleet_launch": ([_P, _I, _I, _I] + [_P] * 9, _I),
    "mppi_fleet_scratch_floats": ([_P], _I),
    "mppi_probe_scale_launch": ([_P, _P, _I, _P], _I),
    "mppi_probe_big_launch": ([_P, _P, _I, _P, _I, _P], _I),
    "mppi_error_string": ([_I], ctypes.c_char_p),
    "mppi_sim_params_size": ([], _I),
    "mppi_solve_params_size": ([], _I),
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed (printing nvcc's report to standard error), load the
    library, declare its C functions and check that each parameter struct
    has the size of its ctypes mirror."""
    from .cuda_sim import _SimParams
    from .cuda_solve import _SolveParams

    print(build(), file=sys.stderr, end="")
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    for name, (argtypes, restype) in C_FUNCTIONS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _check_abi(lib, "mppi_sim_params_size", _SimParams)
    _check_abi(lib, "mppi_solve_params_size", _SolveParams)
    return lib
