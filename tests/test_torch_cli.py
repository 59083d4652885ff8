"""The port's CLI against the JAX package's: the same flags give the same
summary keys, files and record fields; checkpoint/resume; the guards,
including the cuda backends' exit without a CUDA device."""

import contextlib
import io
import json
import os
import tomllib

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu.cli as jcli
import mppi_robotarm_tpu_torch.cli as pcli
import mppi_robotarm_tpu_torch.config as pcfg
import _torch_port_helpers  # noqa: F401  (pins torch to one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--samples", "16", "--horizon", "6"]
EAGER = ["--backend", "eager"]        # the port's CPU path


def _run(main, argv):
    """main(argv) → (rc, the JSON summary on its last stdout line)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def _npz(path) -> dict:
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def test_single_run_outputs_match_jax(tmp_path):
    """Eager vs the JAX package's xla backend on the same flags: the same
    summary keys, file names and record fields and shapes."""
    out_j, out_p = (os.path.join(tmp_path, d) for d in ("j", "p"))
    flags = ["--steps", "5", *SMALL, "--figures", "--render-step", "3"]
    rc_j, sj = _run(jcli.main, flags + ["--out-dir", out_j])
    rc_p, sp = _run(pcli.main, flags + EAGER + ["--out-dir", out_p])
    assert rc_j == rc_p == 0
    assert list(sp) == list(sj)
    assert sp["backend"] == "eager" and sj["backend"] == "xla"
    for k in ("steps", "K", "T"):
        assert sp[k] == sj[k]
    assert sorted(os.listdir(out_p)) == sorted(os.listdir(out_j)) == [
        "figure1_tracking.png", "figure2_controls.png", "record.npz",
        "sampled_step3.png", "summary.json"]
    rj, rp = (_npz(os.path.join(d, "record.npz")) for d in (out_j, out_p))
    assert sorted(rp) == sorted(rj)
    for f in rj:
        assert rp[f].shape == rj[f].shape, f
    with open(os.path.join(out_p, "summary.json")) as f:
        assert json.load(f) == sp
    assert np.isfinite(rp["q"]).all() and not sp["path_end"]


def test_batch_run_outputs_match_jax(tmp_path):
    out_j, out_p = (os.path.join(tmp_path, d) for d in ("j", "p"))
    flags = ["--steps", "4", *SMALL, "--batch", "3"]
    rc_j, sj = _run(jcli.main, flags + ["--out-dir", out_j])
    rc_p, sp = _run(pcli.main, flags + EAGER + ["--out-dir", out_p,
                                                "--figures"])
    assert rc_j == rc_p == 0
    assert list(sp) == list(sj)
    assert (sp["batch"], sp["steps"]) == (sj["batch"], sj["steps"]) == (3, 4)
    bj, bp = (_npz(os.path.join(d, "batch_record.npz"))
              for d in (out_j, out_p))
    assert sorted(bp) == sorted(bj)
    for f in bj:
        assert bp[f].shape == bj[f].shape, f
    assert os.path.exists(os.path.join(out_p, "figure1_tracking.png"))


def test_batch_seeds_and_jitter(tmp_path, monkeypatch):
    """Scenario i's seed is seed + i (the seed the JAX package derives from
    PRNGKey(seed + i)); q0 is jittered from a torch.Generator seeded
    seed + 1, the same draw on every run."""
    import mppi_robotarm_tpu_torch.sim.loop as ploop

    seen = []
    orig = ploop.simulate_batch

    def spy(arm, cfg, sim, ref, states, *a, **k):
        seen.append(states)
        return orig(arm, cfg, sim, ref, states, *a, **k)

    monkeypatch.setattr(ploop, "simulate_batch", spy)
    flags = ["--steps", "2", *SMALL, *EAGER, "--batch", "4", "--seed", "7"]
    ck = os.path.join(tmp_path, "fleet.npz")
    assert _run(pcli.main, flags + ["--checkpoint", ck])[0] == 0
    assert _run(pcli.main, flags)[0] == 0
    assert seen[0].seed.tolist() == [7, 8, 9, 10]
    gen = torch.Generator().manual_seed(8)
    q0 = pcfg.circle_tracking_preset()[2].q0
    want = (torch.tensor([q0], dtype=torch.float32)
            + 0.01 * torch.randn((4, 2), generator=gen))
    assert torch.equal(seen[0].q, want) and torch.equal(seen[1].q, want)
    with np.load(ck) as z:
        assert z["key_data"][:, 1].tolist() == [7, 8, 9, 10]
        assert z["step"].tolist() == [2, 2, 2, 2]


def test_checkpoint_every_resume_equals_uninterrupted(tmp_path):
    d = lambda name: os.path.join(tmp_path, name)
    flags = [*SMALL, *EAGER, "--seed", "3"]
    assert _run(pcli.main, flags + ["--steps", "6", "--checkpoint-every",
                                    "3", "--checkpoint", d("full.npz"),
                                    "--out-dir", d("full")])[0] == 0
    assert _run(pcli.main, flags + ["--steps", "3", "--checkpoint",
                                    d("part.npz"), "--out-dir",
                                    d("first")])[0] == 0
    assert _run(pcli.main, flags + ["--steps", "3", "--checkpoint",
                                    d("part.npz"), "--out-dir",
                                    d("resumed")])[0] == 0
    full, first, resumed = (_npz(d(n + "/record.npz"))
                            for n in ("full", "first", "resumed"))
    for f in full:
        np.testing.assert_array_equal(
            full[f], np.concatenate([first[f], resumed[f]]), err_msg=f)
    a, b = _npz(d("full.npz")), _npz(d("part.npz"))
    assert sorted(a) == sorted(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert int(a["step"]) == 6


def test_guards(monkeypatch):
    with pytest.raises(SystemExit, match="checkpoint-every"):
        pcli.main(["--steps", "4", *SMALL, *EAGER, "--batch", "2",
                   "--checkpoint-every", "2"])
    with pytest.raises(SystemExit, match="render-step"):
        pcli.main(["--steps", "4", *SMALL, *EAGER, "--batch", "2",
                   "--render-step", "1"])
    monkeypatch.setattr(pcli, "_device", lambda backend: torch.device("cpu"))
    with pytest.raises(SystemExit, match="checkpoint-every"):
        pcli.main(["--steps", "4", *SMALL, "--backend", "cuda-fused",
                   "--checkpoint-every", "2"])


@pytest.mark.parametrize("backend", ["cuda", "cuda-fused"])
@pytest.mark.parametrize("batch", ["0", "3"])
def test_cuda_backends_exit_without_a_cuda_device(backend, batch):
    """The cuda backends never fall back to the CPU twins."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA device"):
        pcli.main(["--steps", "2", *SMALL, "--backend", backend,
                   "--batch", batch])


def test_profile_dir_and_config(tmp_path):
    arm, cfg, sim = pcfg.circle_tracking_preset()
    path = os.path.join(tmp_path, "cfg.json")
    with open(path, "w") as f:
        f.write(pcfg.config_to_json(arm, cfg, sim))
    prof = os.path.join(tmp_path, "prof")
    rc, s = _run(pcli.main, ["--steps", "2", *SMALL, *EAGER, "--config", path,
                             "--profile-dir", prof, "--metrics-every", "1"])
    assert rc == 0 and s["K"] == 16
    assert os.path.exists(os.path.join(prof, "trace.json"))


def test_console_script_names_the_port():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["mppi-arm-torch"] == "mppi_robotarm_tpu_torch.cli:main"
    assert scripts["mppi-arm"] == "mppi_robotarm_tpu.cli:main"
