"""The port's entry points run on the GPU unless asked for the CPU.

``init_state``, ``init_sim``, ``init_sim_batch``, the ``convert`` loaders
and ``load_checkpoint`` take ``device=None`` to mean ``cuda`` and raise,
naming the missing device, where there is none; ``device="cpu"`` runs on
the CPU.  The CLI's default backend is ``cuda`` (the counterpart of the JAX
CLI's per-step ``xla`` default) and exits with a message without a CUDA
device; ``--backend eager`` is the CPU path.  The tests of the missing
device decide inside the test whether a card is present.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
import mppi_robotarm_tpu_torch.cli as pcli
from mppi_robotarm_tpu_torch import convert
from mppi_robotarm_tpu_torch.device import resolve_device
from mppi_robotarm_tpu_torch.utils import checkpoint as pck

torch.set_num_threads(1)
CFG = P.MPPIConfig(num_samples=16, horizon=6)
SIM = P.SimConfig()


def _one(device, _):
    return convert.sim_state_from_numpy(
        3, SIM.q0, SIM.dq0, np.zeros((6, 2)), 2, [0, 7], False,
        device=device)


def _batch(device, _):
    return convert.sim_state_batch_from_numpy(
        [3, 3], [SIM.q0] * 2, [SIM.dq0] * 2, np.zeros((2, 6, 2)), [2, 4],
        [[0, 7], [0, 8]], [False, True], device=device)


def _checkpoint(device, tmp_path):
    path = os.path.join(tmp_path, "state.npz")
    pck.save_checkpoint(path, P.init_sim(CFG, SIM, seed=5, device="cpu"))
    return pck.load_checkpoint(path, device=device)


ENTRY_POINTS = {
    "init_state": lambda device, _: P.init_state(CFG, device=device),
    "init_sim": lambda device, _: P.init_sim(CFG, SIM, seed=1,
                                             device=device),
    "init_sim_batch": lambda device, _: P.init_sim_batch(
        CFG, SIM, [1, 2, 3], device=device),
    "sim_state_from_numpy": _one,
    "sim_state_batch_from_numpy": _batch,
    "load_checkpoint": _checkpoint,
}


def _tensors(state):
    return [v for v in torch.utils._pytree.tree_leaves(state)
            if isinstance(v, torch.Tensor)]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_is_cuda_and_raises_without_it(entry, tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        ENTRY_POINTS[entry](None, tmp_path)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_cpu_when_asked(entry, tmp_path):
    for device in ("cpu", torch.device("cpu")):
        tensors = _tensors(ENTRY_POINTS[entry](device, tmp_path))
        assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for device in (None, "cuda", "cuda:0", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)


def test_cli_defaults_to_cuda_and_exits_without_it():
    assert pcli.build_parser().parse_args([]).backend == "cuda"
    _no_cuda()
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        pcli.main(["--steps", "2", "--samples", "16", "--horizon", "6"])


def test_cli_eager_runs_on_the_cpu(monkeypatch):
    seen = []
    real = pcli._device
    monkeypatch.setattr(pcli, "_device",
                        lambda backend: seen.append(real(backend)) or seen[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pcli.main(["--steps", "2", "--samples", "16", "--horizon", "6",
                        "--backend", "eager"])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and summary["backend"] == "eager"
    assert seen == [torch.device("cpu")]
