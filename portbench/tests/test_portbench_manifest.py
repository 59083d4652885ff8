"""``BENCHMARK.json`` against the manifest's format, and the harness's
way of finding a cell's parts by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


def test_names_units_and_keys(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_its_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        mover = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            mover.get("workloads", cells))
    for c in cells:
        cell = harness.load_cell(c, ROOT)
        assert len(cell.end_to_end) >= 2 and len(cell.per_layer) >= 1
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_parts_are_found_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        driver = harness.load(ROOT, "drivers", cell.traffic["driver"])
        for fn in ("prepare", "window", "cases"):
            assert callable(getattr(driver, fn))
        assert driver.KIND in ("rows", "calls")
        for m in cell.end_to_end:
            assert callable(harness.load(ROOT, "endtoend", m["name"]).read)
        for m in cell.per_layer:
            assert callable(harness.load(ROOT, "metrics", m["name"]).read)
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "arm_k1024_h50.fused_short", "config": "arm_k1024_h50",
         "traffic": "fused_chain500", "chips": 1, "why": "shorter chains"})
    for m in bench["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("arm_k1024_h50.fused_short")
    bench["per_layer"].append(
        {"name": "chains_seen", "unit": "chains", "better": "higher",
         "source": "program_counter", "layer": "sim/loop.py",
         "moves": "solves_per_s", "workloads": ["arm_k1024_h50.fused_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tr = tmp_path / "portbench" / "traffic"
    (tr / "fused_chain500.json").write_text(json.dumps(
        {"driver": "fused_chain", "chain_steps": 500, "check_chains": 2,
         "check_from": 4}))
    lim = tmp_path / "portbench" / "limits"
    shutil.copy(lim / "arm_k1024_h50.fused.json",
                lim / "arm_k1024_h50.fused_short.json")
    (tmp_path / "portbench" / "metrics" / "chains_seen.py").write_text(
        "def read(run):\n    return run.window.calls\n")
    cell = harness.load_cell("arm_k1024_h50.fused_short", tmp_path)
    assert cell.traffic["chain_steps"] == 500
    assert "chains_seen" in [m["name"] for m in cell.per_layer]
    assert "solves_per_s" in [m["name"] for m in cell.end_to_end]
    reader = harness.load(tmp_path, "metrics", "chains_seen")
    assert reader.read(type("R", (), {"window": type(
        "W", (), {"calls": 3})})()) == 3
    with pytest.raises(KeyError):
        harness.load_cell("no_such_cell", tmp_path)
