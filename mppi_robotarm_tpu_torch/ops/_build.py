"""Build and load the port's CUDA kernels (``csrc/``) at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into one shared library
with a plain C interface, ``build/torch_kernels/libmppi_kernels.so`` at the
root of the checkout, which ``ctypes`` loads.  A digest of the sources and
flags sits beside the library, so an edit to a source rebuilds it.  A
build holds an exclusive ``flock`` on ``BUILD_DIR/build.lock``, so ranks
or processes that reach their first launch together build once, the rest
waiting and then finding the library current.  The build reports
``ptxas``'s figures (registers, shared memory, spills).  Nothing here
runs at import: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
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
    current = lambda: (lib.exists() and stamp.exists()
                       and stamp.read_text() == digest)
    if current():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released when closed
        if current():                          # built while we waited
            return ""
        return _compile(sources, lib, stamp, digest)


def _compile(sources, lib: Path, stamp: Path, digest: str) -> str:
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (argtypes, restype) of each C function of the library, in the order of
# its declaration in csrc/: c_void_p for every pointer and the stream,
# c_int for every int, c_float for every float.
C_FUNCTIONS = {
    "mppi_sim_launch": ([_P, _I, _I] + [_P] * 9, _I),
    "mppi_solve_launch": ([_P, _I] + [_P] * 15, _I),
    "mppi_fleet_launch": ([_P, _I, _I, _I] + [_P] * 9, _I),
    "mppi_fleet_scratch_floats": ([_P], _I),
    "mppi_probe_scale_launch": ([_P, _P, _I, _P], _I),
    "mppi_probe_big_launch": ([_P, _P, _I, _P, _I, _I, _P], _I),
    "mppi_step_head_launch": ([_P, _P, _I, _P], _I),
    "mppi_step_tail_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "mppi_shard_scale_launch": ([_P] * 5 + [_I, _I, _F, _P], _I),
    "mppi_shard_finish_launch": ([_P] * 3 + [_I] * 3 + [_P], _I),
    "mppi_error_string": ([_I], ctypes.c_char_p),
    "mppi_sim_params_size": ([], _I),
    "mppi_solve_params_size": ([], _I),
    "mppi_step_params_size": ([], _I),
    "mppi_step_head_args_size": ([], _I),
    "mppi_step_tail_args_size": ([], _I),
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed (printing nvcc's report to standard error), load the
    library, declare its C functions and check that each parameter struct
    has the size of its ctypes mirror."""
    from .cuda_sim import _SimParams
    from .cuda_solve import _SolveParams
    from .cuda_step import _HeadArgs, _StepParams, _TailArgs

    print(build(), file=sys.stderr, end="")
    lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
    for name, (argtypes, restype) in C_FUNCTIONS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _check_abi(lib, "mppi_sim_params_size", _SimParams)
    _check_abi(lib, "mppi_solve_params_size", _SolveParams)
    _check_abi(lib, "mppi_step_params_size", _StepParams)
    _check_abi(lib, "mppi_step_head_args_size", _HeadArgs)
    _check_abi(lib, "mppi_step_tail_args_size", _TailArgs)
    return lib
