"""The command as the check runs it: no result without a card, without the
program, or for a cell the manifest lacks; and the result line's form."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "arm_k1024_h50.fused", "--seed", str(2 ** 35 + 1),
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return subprocess.run([sys.executable, *bench["command"][1:], *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_result_line_holds_the_drivers_keys_and_the_checks_last():
    out = {"correct": False, "attempted": 10, "failed": 1,
           "metrics": {"solves_per_s": {"value": 1.5, "unit": "solves/s"}},
           "memory_peak_bytes": 123, "busy_s": 0.5, "window_s": 1.0,
           "breakdown": {"device_ops": [["k", 0.5]], "idle_gaps": []},
           "checks": [("u_gap", float("inf"), 0.1), ("x_gap", 1e-7, 1e-3)]}
    line = harness.result_line(out, "NVIDIA H100 80GB HBM3", 1)
    parsed = json.loads(line)
    assert list(parsed) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert parsed["device"] == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "memory_peak_bytes": 123, "busy_s": 0.5, "window_s": 1.0}
    assert parsed["checks"]["u_gap"] == {"value": "inf", "limit": 0.1}
    assert "Infinity" not in line and "NaN" not in line
