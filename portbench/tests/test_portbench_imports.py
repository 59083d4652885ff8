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
    code = ["from portbench import harness, control, judge, run"]
    for w in bench["workloads"]:
        code.append(f"c = harness.load_cell({w['name']!r})")
        code.append("d = harness.load(c.root, 'drivers', "
                    "c.traffic['driver'])")
        code.append("judge.kind(d.KIND, c.root)")
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


def _kind_names(root: Path) -> set:
    """Top-level modules loaded by loading every kind file of ``root``
    (``portbench/kinds/*.py``) through the judge's lookup."""
    kinds = sorted(p.stem for p in (root / "portbench" / "kinds").glob(
        "*.py"))
    return _top_names(
        "from pathlib import Path\nfrom portbench import judge\n"
        f"for k in {kinds!r}:\n    judge.kind(k, Path({str(root)!r}))")


def test_every_kind_file_loads_nothing_of_the_program():
    """A kind file is part of the yardstick: it compares what the program
    produced with the reference, and loads nothing of the program."""
    names = _kind_names(ROOT)
    assert "mppi_robotarm_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_a_kind_file_that_loads_the_program_is_seen(tmp_path):
    """The same look at a root whose kind files are a sound one and one
    that imports the program: the second is seen."""
    kinds = tmp_path / "portbench" / "kinds"
    kinds.mkdir(parents=True)
    body = ("from portbench import judge\n"
            "count = judge.count\nreadings = control = None\n")
    (kinds / "sound.py").write_text(body)
    assert "mppi_robotarm_tpu_torch" not in _kind_names(tmp_path)
    (kinds / "leaky.py").write_text("import mppi_robotarm_tpu_torch\n" + body)
    assert "mppi_robotarm_tpu_torch" in _kind_names(tmp_path)


def test_a_forbidden_module_is_named():
    from portbench import harness

    sys.modules.setdefault("mppi_robotarm_tpu.fake_probe", object())
    try:
        assert "mppi_robotarm_tpu" in harness.forbidden_modules()
    finally:
        del sys.modules["mppi_robotarm_tpu.fake_probe"]
