"""What the benchmark loads: never JAX or the JAX package, and in the
reference nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mppi_robotarm_tpu"}


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_every_part_load_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    code = ["from portbench import harness, control, run"]
    for w in bench["workloads"]:
        code.append(f"c = harness.load_cell({w['name']!r})")
        code.append("harness.load(c.root, 'drivers', c.traffic['driver'])")
        code.append("[harness.load(c.root, 'endtoend', m['name']) "
                    "for m in c.end_to_end]")
        code.append("[harness.load(c.root, 'metrics', m['name']) "
                    "for m in c.per_layer]")
    names = _top_names("\n".join(code))
    assert "mppi_robotarm_tpu_torch" in names      # the program is loaded
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_and_yardstick_load_nothing_of_the_program():
    names = _top_names(
        "import portbench.reference.mppi, portbench.reference.philox, "
        "portbench.reference.arm, portbench.judge, portbench.roofline, "
        "portbench.inputs, portbench.stats, portbench.trace")
    assert "mppi_robotarm_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_a_forbidden_module_is_named():
    from portbench import harness

    sys.modules.setdefault("mppi_robotarm_tpu.fake_probe", object())
    try:
        assert "mppi_robotarm_tpu" in harness.forbidden_modules()
    finally:
        del sys.modules["mppi_robotarm_tpu.fake_probe"]
