"""Debug and sanitizer modes.

The counterpart of ``mppi_robotarm_tpu/utils/debug.py``:

  * :func:`debug_mode` — within the block, the port's loops and solves
    check the state and the control for non-finite values (``nans``) and
    their invariants (``checks``): a waypoint index within the path and
    never moving back, the absolute step never moving back nor past the
    steps run, a path-end freeze never undone.  The per-step loops check
    after each chunk (``sim/loop.py::_chunk_steps``): the cuda backend's
    between graph replays (a check reads the device, which a captured
    graph may not do), the eager backend's uncaptured; the fused loops
    after each launch, ``solve`` after each solve;
  * :func:`checked_solve` — a solve that returns ``(error, result)``,
    ``error.throw()`` raising at the reference's path end (Q6) or on a
    non-finite control; the check reads one flag from the device after
    the solve;
  * :func:`kernel_race_check` — the solve kernel under NVIDIA's
    ``compute-sanitizer --tool racecheck`` in a subprocess (the JAX
    package runs its kernel in the Mosaic interpreter's race detector).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch


@dataclasses.dataclass
class _Mode:
    nans: bool = False
    checks: bool = False


_MODE = _Mode()


@contextlib.contextmanager
def debug_mode(nans: bool = True, checks: bool = True):
    """Turn the non-finite and invariant checks on within the block; the
    previous setting comes back on exit."""
    old = dataclasses.replace(_MODE)
    _MODE.nans, _MODE.checks = nans, checks
    try:
        yield
    finally:
        _MODE.nans, _MODE.checks = old.nans, old.checks


def active() -> bool:
    """Whether :func:`debug_mode` asks for any check now."""
    return _MODE.nans or _MODE.checks


def check_step(where: str, before, after, n_path: int, steps: int = 1,
               u=None) -> None:
    """The checks of :func:`debug_mode` on a loop's state ``after`` it ran
    ``steps`` steps from ``before`` (two ``SimState``s, single or batched;
    ``u`` the controls applied meanwhile).  One read from the device.
    Raises ``FloatingPointError`` on a non-finite value, ``RuntimeError``
    on a broken invariant."""
    conds = []
    if _MODE.nans:
        for name, v in (("q", after.q), ("dq", after.dq),
                        ("u_prev", after.mppi.u_prev), ("u", u)):
            if v is not None:
                conds.append((FloatingPointError, f"non-finite {name}",
                              torch.isfinite(v).all()))
    if _MODE.checks:
        wp, wp0 = after.mppi.wp_idx, before.mppi.wp_idx
        d_step = after.step - torch.as_tensor(before.step,
                                              device=after.step.device)
        for text, ok in (
                (f"waypoint index outside [0, {n_path - 1}]",
                 ((wp >= 0) & (wp < n_path)).all()),
                ("waypoint index moved back", (wp >= wp0).all()),
                (f"step moved back or past the {steps} steps run",
                 ((d_step >= 0) & (d_step <= steps)).all()),
                ("a path-end freeze was undone",
                 (after.done | ~torch.as_tensor(
                     before.done, device=after.done.device)).all())):
            conds.append((RuntimeError, text, ok))
    _raise_first(where, conds)


def check_solve(where: str, res, n_path: int) -> None:
    """The checks of :func:`debug_mode` on a ``SolveResult``."""
    conds = []
    if _MODE.nans:
        conds += [(FloatingPointError, f"non-finite {name}",
                   torch.isfinite(v).all())
                  for name, v in (("u0", res.u0), ("u_seq", res.u_seq))]
    if _MODE.checks:
        wp = res.state.wp_idx
        conds.append((RuntimeError, f"waypoint index outside [0, "
                      f"{n_path - 1}]", ((wp >= 0) & (wp < n_path)).all()))
    _raise_first(where, conds)


def _raise_first(where: str, conds) -> None:
    if not conds:
        return
    ok = torch.stack([c for _, _, c in conds]).tolist()   # one device read
    for (exc, text, _), good in zip(conds, ok):
        if not good:
            raise exc(f"{where}: {text} (debug_mode)")


class CheckError:
    """The outcome of :func:`checked_solve`: ``get()`` gives the failed
    check's message or None, ``throw()`` raises it (``IndexError`` at the
    path end, as the reference does; ``FloatingPointError`` on a
    non-finite control)."""

    PATH_END = "Reached the end of the reference path."
    NON_FINITE = "non-finite control output"

    def __init__(self, code: int):
        self.code = code

    def get(self):
        if self.code & 1:
            return self.PATH_END
        if self.code & 2:
            return self.NON_FINITE
        return None

    def throw(self) -> None:
        if self.code & 1:
            raise IndexError(self.PATH_END)
        if self.code & 2:
            raise FloatingPointError(self.NON_FINITE)


def checked_solve(arm, cfg, ref_path, observed_x, state, **kw):
    """``mppi/solver.py::solve`` with its path-end and finiteness checks:
    returns ``(CheckError, SolveResult)``.  The keywords go to ``solve``
    (``backend="cuda"`` runs the solve kernel).  The flag is computed on
    the solve's device and read once, after the solve."""
    from ..mppi.solver import solve

    res = solve(arm, cfg, ref_path, observed_x, state, **kw)
    code = (res.path_end.to(torch.int32)
            | (~torch.isfinite(res.u0).all()).to(torch.int32) * 2)
    return CheckError(int(code)), res


def race_check_command(sanitizer: str, workdir: str) -> list:
    """The ``compute-sanitizer`` command :func:`kernel_race_check` runs:
    racecheck over this module's ``--race-case WORKDIR`` in a new
    interpreter."""
    return [sanitizer, "--tool", "racecheck", "--error-exitcode", "9",
            sys.executable, "-m", "mppi_robotarm_tpu_torch.utils.debug",
            "--race-case", workdir]


RACE_TIMEOUT_S = 600.0      # seconds the sanitized process may take


def kernel_race_check(arm, cfg, x0, u, window, nvalid, eps):
    """Run the solve kernel (``solve_core`` on cuda:0, at the tile the main
    path launches, ``cuda_solve.solve_tile``; the JAX package fixes 128)
    under ``compute-sanitizer --tool racecheck`` in a subprocess.
    ``nvalid``, which no version of the solve reads, is not passed on.

    Returns the kernel's outputs (w_eps (T, 2), S (K,), eps (K, T, 2)) as
    CPU tensors.  Raises ``RuntimeError`` when the sanitizer reports a
    hazard or any error, when the run fails, and when the sanitizer is
    missing or cannot run on this machine (it answers "Device not
    supported" on some): a check that did not run never passes.
    """
    from ..config import SimConfig, config_to_json
    from ..tools.sanitize import UNSUPPORTED, sanitizer_path, summary

    sanitizer = sanitizer_path()
    if sanitizer is None:
        raise RuntimeError("kernel_race_check: compute-sanitizer not found; "
                           "the race check did not run")
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "inputs.npz"),
                 **{k: torch.as_tensor(v).detach().cpu().numpy()
                    for k, v in (("x0", x0), ("u", u), ("window", window),
                                 ("eps", eps))})
        with open(os.path.join(workdir, "case.json"), "w") as f:
            json.dump({"config": config_to_json(arm, cfg, SimConfig())}, f)
        try:
            r = subprocess.run(race_check_command(sanitizer, workdir),
                               capture_output=True, text=True,
                               timeout=RACE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"kernel_race_check: no answer from the "
                               f"sanitizer in {RACE_TIMEOUT_S} s")
        out = r.stdout + r.stderr
        if UNSUPPORTED in out:
            raise RuntimeError(f"kernel_race_check: compute-sanitizer "
                               f"reports '{UNSUPPORTED}' on this machine; "
                               f"the race check did not run")
        errors = summary(out)
        if r.returncode != 0 or errors != 0:
            raise RuntimeError(
                f"kernel_race_check: rc {r.returncode}, racecheck errors "
                f"{errors}:\n" + "\n".join(out.splitlines()[-40:]))
        with np.load(os.path.join(workdir, "outputs.npz")) as z:
            return tuple(torch.as_tensor(z[k]) for k in ("w_eps", "s", "eps"))


def _race_case(workdir: str) -> None:
    """The sanitized process: one ``solve_core`` on cuda:0 of the inputs
    in ``workdir`` at the main path's tile, its outputs written back
    there."""
    from ..config import config_from_json
    from ..ops.cuda_solve import solve_core

    with open(os.path.join(workdir, "case.json")) as f:
        case = json.load(f)
    arm, cfg, _ = config_from_json(case["config"])
    device = torch.device("cuda", 0)
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        t = {k: torch.as_tensor(z[k], device=device) for k in z.files}
    w_eps, s, eps = solve_core(arm, cfg, t["x0"], t["u"], t["window"],
                               eps=t["eps"])
    torch.cuda.synchronize(device)
    np.savez(os.path.join(workdir, "outputs.npz"),
             w_eps=w_eps.cpu().numpy(), s=s.cpu().numpy(),
             eps=eps.cpu().numpy())


if __name__ == "__main__":
    if sys.argv[1:2] != ["--race-case"] or len(sys.argv) != 3:
        sys.exit("usage: python -m mppi_robotarm_tpu_torch.utils.debug "
                 "--race-case WORKDIR")
    _race_case(sys.argv[2])
