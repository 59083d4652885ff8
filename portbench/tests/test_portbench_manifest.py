"""``BENCHMARK.json`` against the manifest's format, and the harness's
way of finding a cell's parts by name."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import control, harness, judge, program

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
        assert _kind_is_found(ROOT, driver.KIND)
        for m in cell.end_to_end:
            assert callable(harness.load(ROOT, "endtoend", m["name"]).read)
        for m in cell.per_layer:
            assert callable(harness.load(ROOT, "metrics", m["name"]).read)
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
    for path in sorted((ROOT / "portbench" / "kinds").glob("*.py")):
        assert _kind_is_found(ROOT, path.stem)


def _kind_is_found(root: Path, name: str) -> bool:
    """A driver's ``KIND``: one of judge's own, or a file
    ``portbench/kinds/<name>.py`` with the three callables."""
    if name in judge.KINDS:
        return True
    mod = harness.load(root, "kinds", name)
    return all(callable(getattr(mod, fn, None))
               for fn in ("readings", "control", "count"))


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


# ---- a cell that brings its own comparison ---------------------------------

INJECTED_DRIVER = '''\
"""Traffic: one caller's solves on the eager backend, each handed noise
the caller drew on the host by NumPy's multivariate normal, against a
host plant; every call is kept for the check."""

import time
from typing import NamedTuple

import numpy as np
import torch

from portbench import inputs, program
from portbench.chains import Window
from portbench.reference import arm as arm_model

KIND = "injected"


class Calls(NamedTuple):
    P: dict
    arm: object
    cfg: object
    ref: torch.Tensor
    device: torch.device
    dtype: torch.dtype
    seed: int


def prepare(cell, seed, device):
    P = cell.conf
    arm, cfg, _ = program.configs(P)
    dtype = getattr(torch, P["dtype"])
    ref = torch.as_tensor(inputs.circle_path(P["path"]["waypoints"],
                                             P["sim"]["dt"]),
                          dtype=dtype, device=device)
    return Calls(P, arm, cfg, ref, device, dtype, seed)


def window(c, seconds, closed=lambda: None):
    P, mp = c.P, c.P["mppi"]
    g = inputs.rng(c.seed, 3)
    state = program.port.init_state(c.cfg, dtype=c.dtype, device=c.device)
    x = (*P["sim"]["q0"], *P["sim"]["dq0"])
    kept, latencies = [], []
    before = program.counters()
    t0 = time.perf_counter()
    while not kept or time.perf_counter() - t0 < seconds:
        eps = torch.as_tensor(g.multivariate_normal(
            np.zeros(2), np.asarray(mp["sigma"], dtype=np.float64),
            (mp["num_samples"], mp["horizon"])), dtype=c.dtype,
            device=c.device)
        xd = torch.tensor(x, dtype=c.dtype, device=c.device)
        c0 = time.perf_counter()
        res = program.port.solve(c.arm, c.cfg, c.ref, xd, state, eps=eps,
                                 backend="eager")
        u0 = res.u0.cpu().numpy()
        latencies.append(time.perf_counter() - c0)
        kept.append((xd, state, eps, res))
        x = arm_model.step_host(P["arm"], x, u0, P["sim"]["dt"],
                                tuple(P["sim"]["disturbance"]))
        state = res.state
    t1 = time.perf_counter()
    closed()
    after = program.counters()
    n = len(kept)
    return Window(t0, t1, n, n, n, latencies,
                  {k: after[k] - before[k] for k in after}, kept)


def cases(c, win):
    inp = {"q": [], "dq": [], "u_prev": [], "wp": [], "eps": []}
    prog = {"u0": [], "u_new": [], "wp": []}
    for xd, st, eps, res in win.kept:
        for k, v in (("q", xd[:2]), ("dq", xd[2:]), ("u_prev", st.u_prev),
                     ("wp", st.wp_idx.reshape(())), ("eps", eps)):
            inp[k].append(v)
        for k, v in (("u0", res.u0), ("u_new", res.u_seq),
                     ("wp", res.state.wp_idx.reshape(()))):
            prog[k].append(v)
    stack = lambda d: {k: torch.stack(v) for k, v in d.items()}
    return stack(inp), stack(prog), {}
'''

INJECTED_KIND = '''\
"""Calls whose noise the caller drew: u0, u_seq and the new waypoint index
against the plain reference's solve handed the same noise."""

import torch

from portbench import judge
from portbench.reference import mppi


def count(inp):
    return int(inp["q"].shape[0])


def _solve(P, ref_path, inp, dtype):
    return mppi.solve(P, ref_path, inp["q"], inp["dq"], inp["u_prev"],
                      inp["wp"], None, None, dtype, eps=inp["eps"])


def readings(P, ref_path, inp, prog, dtype):
    r = _solve(P, ref_path, inp, dtype)
    gap = lambda k: [(prog[k].double() - r[k]).abs().flatten(1).amax(1)]
    out = judge.summary({"u0_gap": gap("u0"), "u_seq_gap": gap("u_new")})
    out["wp_miss"] = float((prog["wp"] != r["wp"]).sum())
    return out


def control(P, ref_path, inp, dtype):
    r = _solve(P, ref_path, inp, dtype)
    return {"u0": r["u0"], "u_new": r["u_new"], "wp": r["wp"]}
'''

INJECTED = "arm_k16_t6_f64.injected"


def _injected_root(tmp_path: Path) -> Path:
    """A copy of the benchmark with one cell more, added as files: a
    float64 configuration at K=16, T=6 on a 400-row path, a traffic file,
    a driver whose ``KIND`` is a kind file of its own, the kind file and
    the cell's limits.  No file of the copy is edited but
    ``BENCHMARK.json``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "arm_k1024_h50.json").read_text())
    conf.update(name="arm_k16_t6_f64", dtype="float64")
    conf["mppi"].update(num_samples=16, horizon=6)
    conf["path"]["waypoints"] = 400
    (pb / "configs" / "arm_k16_t6_f64.json").write_text(json.dumps(conf))
    (pb / "traffic" / "injected_calls.json").write_text(
        json.dumps({"driver": "injected_calls"}))
    (pb / "drivers" / "injected_calls.py").write_text(INJECTED_DRIVER)
    (pb / "kinds").mkdir(exist_ok=True)
    (pb / "kinds" / "injected.py").write_text(INJECTED_KIND)
    (pb / "limits" / f"{INJECTED}.json").write_text(json.dumps(
        {"u0_gap": 1e-9, "u_seq_gap": 1e-9, "wp_miss": 0}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(
        {"name": "arm_k16_t6_f64", "source": conf["source"],
         "file": "portbench/configs/arm_k16_t6_f64.json", "reduced": [],
         "why": "run.py's arm in float64 at a test's size"})
    bench["workloads"].append(
        {"name": INJECTED, "config": "arm_k16_t6_f64",
         "traffic": "injected_calls", "chips": 1,
         "why": "eager solves handed host-drawn noise"})
    for m in bench["end_to_end"]:
        if m["name"] == "call_ms_p95":
            m["workloads"].append(INJECTED)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _measure_injected(root: Path) -> dict:
    return harness.measure(harness.load_cell(INJECTED, root), 2 ** 33 + 17,
                           0.3, False, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a: None)


def test_a_cell_with_its_own_kind_is_judged_by_its_file(tmp_path):
    """The cell's driver names the kind ``injected``, which is no kind of
    judge's own: the harness measures and judges the cell by
    ``kinds/injected.py``'s readings, the control is that file's, in the
    precision below the configuration's float64, and it fails."""
    root = _injected_root(tmp_path)
    cell = harness.load_cell(INJECTED, root)
    driver = harness.load(root, "drivers", cell.traffic["driver"])
    assert driver.KIND not in judge.KINDS and _kind_is_found(root,
                                                             driver.KIND)
    out = _measure_injected(root)
    assert out["correct"], out["checks"]
    assert [n for n, _, _ in out["checks"]] == ["u0_gap", "u_seq_gap",
                                                "wp_miss"]
    assert out["attempted"] > 1 and "call_ms_p95" in out["metrics"]
    assert control.below(cell.conf) == torch.float32
    o = control.seed_readings(cell, driver, 5, 0.2, torch.device("cpu"),
                              True)
    assert o["answers"] >= 1
    assert set(o["program"]) == set(o["control"]) == {
        "u0_gap", "u0_gap_p99", "u_seq_gap", "u_seq_gap_p99", "wp_miss"}
    assert judge.verdict(o["program"], cell.limits)[0], o
    assert not judge.verdict(o["control"], cell.limits)[0], o
    with pytest.raises(FileNotFoundError):
        judge.kind("no_such_kind", root)


def test_a_fault_in_what_the_program_returned_fails_the_own_kind(
        tmp_path, monkeypatch):
    """u0 altered where the solve returns it: the kind file's reading
    fails the cell."""
    root = _injected_root(tmp_path)
    solve = program.port.solve

    def altered(*a, **k):
        res = solve(*a, **k)
        return res._replace(u0=res.u0 + 0.5)
    monkeypatch.setattr(program.port, "solve", altered)
    out = _measure_injected(root)
    assert not out["correct"], out["checks"]


def test_every_cell_keeps_bfloat16_as_its_control():
    """Every configuration of the benchmark states float32, so each cell's
    control stays the reference in bfloat16."""
    for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        assert control.below(cell.conf) == torch.bfloat16, w["name"]
