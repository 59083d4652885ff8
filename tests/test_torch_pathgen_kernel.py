"""``ops/cuda_pathgen.py``: the path generator's closed loop as one kernel
(``csrc/pathgen_kernel.cu``) and its plain version.

On the CPU:
* :func:`pathgen_reference` on the port's targets against the JAX
  package's ``generate_circle_path`` in float32, in the bands of
  tests/test_torch_pathgen.py (x, y 1e-6, dq 1e-5, u 1e-3; measured 2.4e-7,
  1.1e-6, 9.3e-5), and in float64 against the JAX scan's body
  (``mppi_robotarm_tpu/sim/pathgen.py:55-69``) run from a float64 start,
  as the JAX function starts in float32 whatever x64 says: x, y within
  1e-14, dq 1e-13, u 1e-11 (measured 4.4e-16, 1.9e-15, 2.2e-13; the loop
  is PD-stable, so rounding does not grow);
* the wrapper on CPU tensors is the plain version and counts no launch;
  ``generate_circle_path`` makes one call of it;
* the kernel's scalar constants are the Python expressions of
  ``models/arm.py`` for any arm, in a struct of 18 doubles.

Marked ``cuda`` and skipped without a card: the kernel against its plain
version on the same card tensors in float32 and float64, bit for bit (the
same operations in the same order), one launch a call.  The file imports
JAX inside a ``try``, so on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_pathgen_kernel.py -m cuda
"""

import ctypes
import math

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.models.arm import mass_matrix
from mppi_robotarm_tpu_torch.ops import cuda_pathgen
from mppi_robotarm_tpu_torch.sim import pathgen

try:        # the GPU machine has no JAX: there only the cuda test runs
    import jax
    import jax.numpy as jnp
    from jax import lax

    import mppi_robotarm_tpu as J
    from mppi_robotarm_tpu.models import arm as jarm
    from mppi_robotarm_tpu.sim.pathgen import generate_circle_path as jgen
except ImportError:
    jax = None

torch.set_num_threads(1)
ARM = P.ArmParams()
DT, RATE, KP, KD = 0.003, 2.0 * math.pi / 6.0, 100.0, 20.0
STEPS = 2000
BANDS = {torch.float32: (1e-6, 1e-5, 1e-3), torch.float64: (1e-14, 1e-13,
                                                             1e-11)}


def _targets(dtype, device="cpu", steps=STEPS):
    return pathgen.circle_targets(steps, DT, RATE, dtype, device)


def _within(got, want, dtype):
    d = np.abs(np.asarray(got) - np.asarray(want)).max(axis=0)
    xy, dq, u = BANDS[dtype]
    assert d[0:2].max() <= xy and d[2:4].max() <= dq and d[4:6].max() <= u, d


def _jax_scan_f64(steps):
    """The body of the JAX package's generate_circle_path (:55-69), from
    the IK of θ = 0 in float64."""
    arm = J.ArmParams()
    ik_r = lambda th: jarm.ik_circle(th)[0]
    ik_dr = jax.jacfwd(ik_r)
    ik_ddr = jax.jacfwd(ik_dr)

    def body(carry, k):
        q, dq = carry
        theta = RATE * DT * k.astype(q.dtype)
        v = jarm.pd_outer_loop(q, dq, ik_r(theta), ik_dr(theta) * RATE,
                               ik_ddr(theta) * RATE ** 2, kp=KP, kd=KD)
        u1, u2 = jarm.feedback_linearization(q[0], q[1], dq[0], dq[1], v[0],
                                             v[1], arm)
        ddq1, ddq2 = jarm.arm_ddq(q[0], q[1], dq[0], dq[1], u1, u2, arm)
        dq = dq + DT * jnp.stack([ddq1, ddq2])
        q = q + DT * dq
        x, y = jarm.fk_ee(q[0], q[1], arm.l1, arm.l2)
        return (q, dq), jnp.stack([x, y, dq[0], dq[1], u1, u2])

    q0 = ik_r(jnp.float64(0.0))
    return lax.scan(body, (q0, jnp.zeros(2, q0.dtype)), jnp.arange(steps))[1]


def test_pathgen_reference_matches_jax_float32():
    if jax is None:
        pytest.skip("needs the JAX package")
    got = cuda_pathgen.pathgen_reference(ARM, *_targets(torch.float32), DT,
                                         KP, KD)
    assert got.dtype == torch.float32 and got.shape == (STEPS, 6)
    _within(got.numpy(), jgen(J.ArmParams(), STEPS), torch.float32)


def test_pathgen_reference_matches_the_jax_scan_float64():
    if jax is None:
        pytest.skip("needs the JAX package")
    got = cuda_pathgen.pathgen_reference(ARM, *_targets(torch.float64), DT,
                                         KP, KD)
    assert got.dtype == torch.float64
    _within(got.numpy(), _jax_scan_f64(STEPS), torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_wrapper_takes_the_plain_version_on_the_cpu(dtype):
    before = cuda_pathgen.LAUNCHES
    tgt = _targets(dtype, steps=300)
    got = cuda_pathgen.pathgen(ARM, *tgt, DT, KP, KD)
    assert torch.equal(got, cuda_pathgen.pathgen_reference(ARM, *tgt, DT,
                                                           KP, KD))
    assert cuda_pathgen.LAUNCHES == before


def test_generate_circle_path_calls_the_wrapper_once(monkeypatch):
    calls = []
    real = pathgen.pathgen

    def counting(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(pathgen, "pathgen", counting)
    rows = pathgen.generate_circle_path(ARM, 50, device="cpu")
    assert len(calls) == 1 and rows.shape == (50, 6)
    q0, r, dr, ddr = calls[0][1:5]
    assert q0.shape == (2,) and r.shape == dr.shape == ddr.shape == (50, 2)
    assert all(t.is_contiguous() for t in (q0, r, dr, ddr))


@pytest.mark.parametrize("arm", [P.ArmParams(),
                                 P.ArmParams(m1=1.3, m2=0.7, l1=1.1, l2=0.9,
                                             lc1=0.45, lc2=0.55, g=9.7)])
def test_the_kernels_constants_are_the_models_expressions(arm):
    p = cuda_pathgen._params(arm, DT, KP, KD)
    assert ctypes.sizeof(p) == 18 * 8
    want = {
        "m11_a": arm.m1 * arm.lc1 ** 2 + arm.l1,
        "m11_b": arm.l1 ** 2 + arm.lc2 ** 2, "m11_c": 2.0 * arm.l1 * arm.lc2,
        "m2": arm.m2, "l2": arm.l2, "m2l1lc2": arm.m2 * arm.l1 * arm.lc2,
        "m2lc2sq": arm.m2 * arm.lc2 ** 2,
        "m22": arm.m2 * arm.lc2 ** 2 + arm.l2,
        "m1lc1g": arm.m1 * arm.lc1 * arm.g, "m2g": arm.m2 * arm.g,
        "lc2": arm.lc2, "l1": arm.l1, "m2lc2g": arm.m2 * arm.lc2 * arm.g,
        "kp": KP, "kd": KD, "dt": DT, "fk_l1": arm.l1, "fk_l2": arm.l2}
    assert {k: getattr(p, k) for k in want} == want
    # the plain version reads the same arm: M22 enters as one Python float
    m22 = mass_matrix(torch.tensor(0.3), arm)[3]
    assert isinstance(m22, float) and m22 == want["m22"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pathgen_kernel_equals_its_plain_version_on_the_card(dtype):
    """One launch, the plain version's bits on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tgt = _targets(dtype, device="cuda")
    before = cuda_pathgen.LAUNCHES
    got = cuda_pathgen.pathgen(ARM, *tgt, DT, KP, KD)
    torch.cuda.synchronize()
    assert cuda_pathgen.LAUNCHES == before + 1
    want = cuda_pathgen.pathgen_reference(ARM, *tgt, DT, KP, KD)
    assert got.dtype == dtype and got.shape == (STEPS, 6)
    assert torch.equal(got, want), (got - want).abs().amax(0)
    before = cuda_pathgen.LAUNCHES
    rows = pathgen.generate_circle_path(ARM, STEPS, dtype=dtype)
    assert cuda_pathgen.LAUNCHES == before + 1 and torch.equal(rows, got)
