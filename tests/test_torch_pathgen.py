"""The arm model's legacy control law, ``ops/filters.py::
moving_average_filter`` and ``sim/pathgen.py`` of the port against the JAX
package, with the same NumPy-made inputs: the three arm functions and the
filter in float64 to about 1e-12 (``tests/test_arm.py``,
``tests/test_filters.py``), ``generate_circle_path`` in float32 (the
measured largest difference over 2000 steps was 2.4e-7 in x, y, 1.1e-6 in
dq, 9.3e-5 in the torques of magnitude ~10-50, so the bands are x, y 1e-6,
dq 1e-5, u 1e-3), and the ``save_path_file`` round trip.

The cuda-marked test at the end is chip_smoke phase 19's twin for the path
generator; it imports nothing of JAX, so on a GPU machine without JAX

    python -m pytest --noconftest tests/test_torch_pathgen.py -m cuda
"""

import math
import os
import time

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.models import arm as parm
from mppi_robotarm_tpu_torch.ops.filters import moving_average_filter
from mppi_robotarm_tpu_torch.sim.pathgen import (generate_circle_path,
                                                 save_path_file)

try:        # the GPU machine has no JAX: there only the cuda test runs
    import jax.numpy as jnp

    import mppi_robotarm_tpu as J
    from mppi_robotarm_tpu.models import arm as jarm
    from mppi_robotarm_tpu.ops.filters import moving_average_filter as jmaf
    from mppi_robotarm_tpu.sim.pathgen import generate_circle_path as jgen
except ImportError:
    jnp = None

torch.set_num_threads(1)
ARM = P.ArmParams()
F64 = torch.float64


def _rand(seed, n=6, size=(3, 2)):
    return [np.random.default_rng(seed + i).normal(size=size)
            for i in range(n)]


def test_feedback_linearization_matches_jax():
    q1, q2, dq1, dq2, v1, v2 = _rand(1)
    got = parm.feedback_linearization(
        *(torch.as_tensor(v) for v in (q1, q2, dq1, dq2, v1, v2)), ARM)
    want = jarm.feedback_linearization(
        *(jnp.asarray(v) for v in (q1, q2, dq1, dq2, v1, v2)), J.ArmParams())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)


def test_feedback_linearization_inverts_dynamics():
    """u = FL(q, dq, v)  ⇒  arm_ddq(q, dq, u) == v (test_arm.py)."""
    q, dq, v = np.random.default_rng(8).normal(size=(3, 2))
    x = [torch.tensor(float(a), dtype=F64) for a in (*q, *dq, *v)]
    u1, u2 = parm.feedback_linearization(*x, ARM)
    dd1, dd2 = parm.arm_ddq(*x[:4], u1, u2, ARM)
    np.testing.assert_allclose([float(dd1), float(dd2)], v, rtol=1e-8,
                               atol=1e-8)


def test_pd_outer_loop_matches_jax():
    q, dq, r, dr, ddr = _rand(2, n=5, size=(4, 2))
    got = parm.pd_outer_loop(*(torch.as_tensor(v) for v in (q, dq, r, dr,
                                                             ddr)))
    want = jarm.pd_outer_loop(*(jnp.asarray(v) for v in (q, dq, r, dr, ddr)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got.numpy(),
                               ddr - 20.0 * (dq - dr) - 100.0 * (q - r),
                               rtol=1e-12)


def test_arm_step_fblin_matches_jax_and_is_a_double_integrator():
    """The ``_F1`` step goes through M and C with g = 0, so it is ddq = v
    up to rounding (test_arm.py), and equals JAX's to 1e-12."""
    q1, q2, dq1, dq2, v1, v2 = _rand(3)
    dt = 0.006
    got = parm.arm_step_fblin(
        *(torch.as_tensor(v) for v in (q1, q2, dq1, dq2, v1, v2)), dt, ARM)
    want = jarm.arm_step_fblin(
        *(jnp.asarray(v) for v in (q1, q2, dq1, dq2, v1, v2)), dt,
        J.ArmParams())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    dq_exp = np.stack([dq1 + v1 * dt, dq2 + v2 * dt])
    np.testing.assert_allclose(torch.stack(got[2:]).numpy(), dq_exp,
                               rtol=1e-10)
    # gravity enters nowhere: another g gives the same step
    other = parm.arm_step_fblin(
        *(torch.as_tensor(v) for v in (q1, q2, dq1, dq2, v1, v2)), dt,
        P.ArmParams(g=3.0))
    for a, b in zip(got, other):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", [3, 4, 5, 10])
def test_moving_average_matches_jax_and_reference(size):
    x = np.random.default_rng(size).normal(size=(30, 2))
    got = moving_average_filter(torch.as_tensor(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(jmaf(jnp.asarray(x), size)),
                               rtol=1e-12, atol=1e-12)
    b = np.ones(size) / size
    exp = np.stack([np.convolve(x[:, d], b, mode="same") for d in range(2)],
                   axis=1)
    n_conv = math.ceil(size / 2)
    exp[0] *= size / n_conv
    for i in range(1, n_conv):
        exp[i] *= size / (i + n_conv)
        exp[-i] *= size / (i + n_conv - (size % 2))
    np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-12)


def test_generate_circle_path_matches_jax():
    steps = 2000
    got = generate_circle_path(ARM, steps, device="cpu")
    want = np.asarray(jgen(J.ArmParams(), steps))
    assert got.dtype == torch.float32 and got.shape == (steps, 6)
    d = np.abs(got.numpy() - want).max(axis=0)
    assert d[0:2].max() <= 1e-6, d
    assert d[2:4].max() <= 1e-5, d
    assert d[4:6].max() <= 1e-3, d
    g = got.numpy()
    r = np.hypot(g[:, 0] - 0.8, g[:, 1] - 0.8)
    np.testing.assert_allclose(r, 0.6, atol=2e-2)


def test_generate_circle_path_float64_and_file_round_trip(tmp_path):
    rows = generate_circle_path(ARM, 300, dtype=F64, device="cpu")
    assert rows.dtype == F64
    f = os.path.join(tmp_path, "gen_circle.txt")
    save_path_file(f, rows)
    with open(f) as fh:
        first = fh.readline().split()
    assert len(first) == 6 and all("e" in v for v in first)
    assert len(first[0].split("e")[0].split(".")[1]) == 18    # %.18e
    np.testing.assert_array_equal(np.loadtxt(f), rows.numpy())
    back = P.load_ref_path(f, dtype=np.float64)
    np.testing.assert_array_equal(back, rows[:, 0:4].numpy())


def test_generate_circle_path_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_circle_path(ARM, 10)


@pytest.mark.cuda
def test_generate_circle_path_on_the_card():
    """chip_smoke phase 19: on cuda against the same call on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    dev = generate_circle_path(ARM, 2000).cpu()
    seconds = time.perf_counter() - t0
    cpu = generate_circle_path(ARM, 2000, device="cpu")
    d = (dev - cpu).abs().amax(dim=0)
    assert float(d[0:2].max()) <= 1e-6 and float(d[4:6].max()) <= 1e-3, d
    assert seconds < 60
