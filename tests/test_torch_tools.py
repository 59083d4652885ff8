"""The port's measurement tools on the CPU: ``tools/sass_loops.py`` on
saved listings in ``cuobjdump -sass``'s and ``nvdisasm -gi``'s formats, the
parts of ``tools/fused_timing.py`` that need no card (the launch settings
of its three modes, the fingerprint and the on-path mean), the argument
handling of ``tools/sanitize.py``, ``tools/combine_clocks.py``'s
stamps against the solve kernel's source, ``tools/smoke_ab.py`` on
stand-in trees, and ``tools/call_graphs.py``'s comparisons under the
replaying CUDA-graph stand-in."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_sim
from mppi_robotarm_tpu_torch.tools import (call_graphs, combine_clocks,
                                           fused_timing, sanitize,
                                           sass_loops, smoke_ab)
from _torch_port_helpers import (counted_kernels,  # noqa: F401 (fixtures)
                                 replaying_capture)

# A rollout loop 0x30-0xf0 holding two of the three Philox multiplies (one
# hoisted before it), with a window scan 0x60-0xa0 (two rows a pass) and a
# Payne-Hanek reduction 0xb0-0xd0 nested in it; fleet_kernel's one loop
# holds no Philox multiply.
_ENC = "/* 0x000fe20000000800 */"
_SIM = [(0x00, "LDC R1, c[0x0][0x28]"),
        (0x10, "IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ"),
        (0x20, "MOV R5, R6"),
        (0x30, "IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ"),
        (0x40, "IMAD.WIDE.U32 R8, R9, 0xd2511f53, RZ"),
        (0x50, "MUFU.SIN R10, R11"),
        (0x60, "LDS.128 R12, [R3]"),
        (0x70, "FSETP.GEU.AND P0, PT, R12, R25, PT"),
        (0x80, "FSETP.GEU.AND P1, PT, R13, R26, PT"),
        (0x90, "FADD R14, R14, R15"),
        (0xa0, "@P2 BRA 0x60"),
        (0xb0, "LDG.E R16, desc[UR4][R18.64]"),
        (0xc0, "STL [R1], R16"),
        (0xd0, "@P3 BRA 0xb0"),
        (0xe0, "STG.E desc[UR4][R20.64], R2"),
        (0xf0, "@P0 BRA 0x30"),
        (0x100, "EXIT")]
_FLEET = [(0x00, "MOV R1, R2"),
          (0x10, "FADD R3, R3, R4"),
          (0x20, "@!P0 BRA 0x0"),
          (0x30, "EXIT")]


def _listing():
    out = ["", "Fatbin elf code:", "================", "arch = sm_90a", "",
           "\tcode for sm_90a"]
    for name, insns in (("_Z10sim_kernel9SimParamsPKfPKiS1_S1_S1_PfS4_S4_",
                         _SIM),
                        ("_Z12fleet_kernel9SimParamsiPKfPKiS1_S1_S1_PfS4_S4_",
                         _FLEET)):
        out.append(f"\t\tFunction : {name}")
        out.append('\t.headerflags\t@"EF_CUDA_SM90"')
        for addr, text in insns:
            out.append(f"        /*{addr:04x}*/                   {text} ;"
                       f"          {_ENC}")
            out.append(f"{'':101}{_ENC}")
    return "\n".join(out) + "\n"


def test_sass_functions_reads_every_instruction_once():
    funcs = sass_loops.functions(_listing())
    sim = next(v for k, v in funcs.items() if "sim_kernel" in k)
    assert sim == _SIM
    assert len(funcs) == 2


def test_sass_loops_are_the_backward_branches():
    assert sass_loops.loops(_SIM) == [(0x60, 0xa0), (0xb0, 0xd0),
                                      (0x30, 0xf0)]
    assert sass_loops.rollout_loop(_SIM) == (0x30, 0xf0)
    assert sass_loops.rollout_loop(_FLEET) is None


@pytest.mark.parametrize("W,per_step", [(30, 13 - 5 - 3 + 15 * 5),
                                        (31, 13 - 5 - 3 + 16 * 5),
                                        (2, 13 - 5 - 3 + 1 * 5)])
def test_sass_describe_counts_a_horizon_step(W, per_step):
    lines = sass_loops.describe("sim_kernel", _SIM, W=W)
    assert lines[0].startswith("sim_kernel: rollout loop 0x30-0xf0, 13 "
                               "instructions (static), 2 Philox multiplies")
    assert "0x60-0xa0: 5 instructions (window scan, 2 rows a pass)" in lines[1]
    assert "0xb0-0xd0: 3 instructions (Payne-Hanek reduction)" in lines[2]
    assert lines[3] == ("  by class: other 5, branch 3, special function 1, "
                        "shared load 1, global load 1, local store 1, "
                        "global store 1")
    assert lines[4] == (f"  one horizon step at W={W} issues at most "
                        f"{per_step} instructions on the fast path")


def test_sass_main_reads_a_saved_listing(tmp_path, capsys):
    f = tmp_path / "sass.txt"
    f.write_text(_listing())
    assert sass_loops.main([str(f)]) == 0
    out = capsys.readouterr().out
    assert "sim_kernel: rollout loop 0x30-0xf0" in out
    assert "fleet_kernel: no loop holds the Philox rounds" in out
    f.write_text("\tcode for sm_90a\n")
    assert sass_loops.main([str(f)]) == 1


@pytest.mark.parametrize("K,want", [(1024, [1, 2, 4, 8]), (100, [1, 2, 4]),
                                    (8192, [1, 2, 4, 8]), (64, [1, 2])])
def test_fused_timing_settings_are_the_sizes_that_fit(K, want):
    rows = fused_timing.settings(K)
    assert [kw["cluster"] for _, kw in rows] == want
    assert [label for label, _ in rows] == [f"cluster={c}" for c in want]
    assert fused_timing.settings(K, clusters=[8, 1]) == [
        (f"cluster={c}", {"cluster": c}) for c in (1, 8) if c in want]
    assert fused_timing.settings(K, default=True) == [("default", {})]
    assert all(c in cuda_sim.CLUSTER_SIZES for c in want)


def test_fused_timing_digest_is_of_the_bytes():
    a = torch.arange(6, dtype=torch.float32).view(2, 3)
    b = torch.ones(2)
    assert fused_timing.digest(a, b) == fused_timing.digest(a.t().t(), b)
    assert fused_timing.digest(a, b) == fused_timing.digest(
        a.t().contiguous().t(), b)
    assert fused_timing.digest(a, b) != fused_timing.digest(b, a)


def test_fused_timing_live_onpath_mm_skips_frozen_steps():
    path = np.array([[0.0, 0.0], [1.0, 0.0]])
    ee = torch.tensor([[0.0, 0.003], [1.0, -0.001], [5.0, 5.0]])
    done = torch.tensor([False, False, True])
    rec = P.SimRecord(*(ee if f == "ee" else done if f == "done" else None
                        for f in P.SimRecord._fields))
    mean, n = fused_timing.live_onpath_mm(rec, path)
    assert n == 2 and mean == pytest.approx(2.0, rel=1e-6)


# A listing in nvdisasm -gi's format (a cubin built with -lineinfo): source
# locations innermost first, branch targets as labels.  Against _DEV below,
# the rollout loop 0x10-0xa0 holds two Philox instructions, a sincosf
# instruction and its local store, a one-row window scan 0x50-0x70 (its
# shared load, compare and branch), the divide, a spill and the branch.
_DEV = """// device helpers
MPPI_HD void philox4x32_10(uint32_t c[4]) {
  c[0] = c[1] * 3;
}
template <bool kAhead = true>
__device__ __forceinline__ void window_cost(float x,
                                            int W) {
  float d = x * x;
}
__device__ void step(float q, float det) {
  sincosf(q, &s, &c);
  const float inv = 1.0f / det;
  q = q + 1;
}
"""
_LINEINFO = """
.text._Z12fleet_kernelILi2ELi1EEv9SimParams:
\t//## File "/elsewhere/dev.cuh", line 3 inlined at "/elsewhere/k.cu", line 20
\t//## File "/elsewhere/k.cu", line 20
        /*0000*/                   IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ ;
.L_x_1:
        /*0010*/                   IMAD.WIDE.U32 R8, R9, 0xd2511f53, RZ ;
        /*0020*/                   IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ ;
\t//## File "/elsewhere/dev.cuh", line 11 inlined at "/elsewhere/k.cu", line 21
\t//## File "/elsewhere/k.cu", line 21
        /*0030*/                   FMUL R10, R11, 0.63661974668502807617 ;
        /*0040*/                   STL [R1], R10 ;
.L_x_2:
\t//## File "/elsewhere/dev.cuh", line 8 inlined at "/elsewhere/k.cu", line 22
\t//## File "/elsewhere/k.cu", line 22
        /*0050*/                   LDS.64 R12, [R3] ;
        /*0060*/                   FSETP.GEU.AND P0, PT, R12, R25, PT ;
        /*0070*/               @P2 BRA `(.L_x_2) ;
\t//## File "/elsewhere/dev.cuh", line 12
        /*0080*/                   MUFU.RCP R4, R15 ;
\t//## File "/elsewhere/k.cu", line 23
        /*0090*/                   LDL R5, [R1+0x4] ;
\t//## File "/elsewhere/dev.cuh", line 13
        /*00a0*/               @P0 BRA `(.L_x_1) ;
        /*00b0*/                   EXIT ;
"""


def test_sass_parse_resolves_labels_and_source_chains():
    funcs, locs = sass_loops.parse(_LINEINFO)
    name = "_Z12fleet_kernelILi2ELi1EEv9SimParams"
    insns = funcs[name]
    assert len(insns) == 12
    assert insns[7] == (0x70, "@P2 BRA 0x50")
    assert insns[10] == (0xa0, "@P0 BRA 0x10")
    assert sass_loops.loops(insns) == [(0x50, 0x70), (0x10, 0xa0)]
    assert locs[name][0x20] == [("/elsewhere/dev.cuh", 3),
                                ("/elsewhere/k.cu", 20)]
    assert locs[name][0x80] == [("/elsewhere/dev.cuh", 12)]
    assert sass_loops.template_args(name) == "<2,1>"
    assert sass_loops.template_args("_Z10sim_kernel9SimParams") == ""


def test_sass_source_functions_span_their_bodies(tmp_path):
    (tmp_path / "dev.cuh").write_text(_DEV)
    assert sass_loops.source_functions(tmp_path / "dev.cuh") == [
        ("philox4x32_10", 2, 4), ("window_cost", 6, 9), ("step", 10, 14)]


@pytest.mark.parametrize("W,scan", [(30, 30), (7, 7)])
def test_sass_groups_split_the_rollout_loop(tmp_path, W, scan):
    (tmp_path / "dev.cuh").write_text(_DEV)
    funcs, locs = sass_loops.parse(_LINEINFO)
    name, insns = next(iter(funcs.items()))
    got = sass_loops.groups(insns, locs[name], W=W,
                            sources=sass_loops.SourceGroups(tmp_path))
    assert got == {"window scan": [2, 2 * scan], "sincosf": [1, 1],
                   "Philox and Box-Muller": [2, 2], "divide": [1, 1],
                   "shared load": [1, scan], "local memory": [2, 2],
                   "other": [1, 1],
                   "local memory by source": {"sincosf": 1, "other": 1}}
    line, = sass_loops.describe_groups("fleet_kernel<2,1>", insns,
                                       locs[name], W=W,
                                       sources=sass_loops.SourceGroups(
                                           tmp_path))
    assert line.startswith(f"fleet_kernel<2,1>: rollout loop by source "
                           f"group (static / one horizon step at W={W}): "
                           f"window scan 2 / {2 * scan}, sincosf 1 / 1")
    assert line.endswith("; local memory on the lines of other 1, sincosf 1")


# _LINEINFO's loop with its window scan compiled at its width: the row's
# shared load, compare and select straight-line in the body, no branch
# back, and the scan's function under another name.
_LINEINFO_FLAT = (_LINEINFO.replace(".L_x_2:\n", "")
                  .replace("@P2 BRA `(.L_x_2)", "FSEL R25, R12, R25, P0"))
_DEV_FLAT = _DEV.replace("void window_cost(", "void scan_rows_at(")


@pytest.mark.parametrize("W", [30, 7])
def test_sass_groups_count_a_loop_free_scan_once_a_step(tmp_path, W):
    """A scan with no loop of its own counts what one horizon step issues
    at any W, and takes the window scan's group whatever its function is
    named."""
    (tmp_path / "dev.cuh").write_text(_DEV_FLAT)
    funcs, locs = sass_loops.parse(_LINEINFO_FLAT)
    name, insns = next(iter(funcs.items()))
    assert sass_loops.loops(insns) == [(0x10, 0xa0)]
    got = sass_loops.groups(insns, locs[name], W=W,
                            sources=sass_loops.SourceGroups(tmp_path))
    assert got == {"window scan": [2, 2], "sincosf": [1, 1],
                   "Philox and Box-Muller": [2, 2], "divide": [1, 1],
                   "shared load": [1, 1], "local memory": [2, 2],
                   "other": [1, 1],
                   "local memory by source": {"sincosf": 1, "other": 1}}
    lines = sass_loops.describe("fleet_kernel<4,1,30>", insns, W=W)
    assert len(lines) == 3 and lines[2] == (
        f"  one horizon step at W={W} issues at most 10 instructions on "
        f"the fast path")


def test_sass_main_groups_a_saved_listing(tmp_path, capsys):
    f = tmp_path / "lineinfo.txt"
    f.write_text(_LINEINFO)
    assert sass_loops.main(["--groups", str(f)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("fleet_kernel<2,1>: rollout loop by source group")
    assert sass_loops.main([str(f)]) == 0
    assert "fleet_kernel<2,1>: rollout loop 0x10-0xa0, 10 instructions" in (
        capsys.readouterr().out)


def test_fused_timing_fleet_settings_put_k3_before_k1():
    assert fused_timing.fleet_settings() == [("group=8", {"group": 8}),
                                             ("group=1", {"group": 1})]


def test_fused_timing_solve_shapes_cover_every_k1024_layout():
    """B = 1, 8 and 64 at K=1024 take 4, 2 and 1 lanes a sample on an
    H100; then the reference config's one tile a scenario, the large-K
    solve and the fleet's per-step solve."""
    assert [s[1:] for s in fused_timing.solve_shapes()] == [
        (1, 1024, 50), (8, 1024, 50), (64, 1024, 50), (8, 100, 30),
        (1, 65536, 50), (4096, 128, 30)]


def test_sass_digests_tell_kernels_and_builds_apart(tmp_path, capsys):
    """One digest a kernel, the same for the same instructions at another
    place in the library, another for one changed instruction."""
    got = sass_loops.digests(_listing())
    assert len(got) == 2 and len(set(got.values())) == 2
    moved = _listing().replace("Fatbin elf code:", "Fatbin elf code:\n")
    assert sass_loops.digests(moved) == got
    changed = _listing().replace("FADD R14, R14, R15", "FMUL R14, R14, R15")
    sim = next(k for k in got if "sim_kernel" in k)
    assert sass_loops.digests(changed)[sim] != got[sim]
    f = tmp_path / "lib.sass"
    f.write_text(_listing())
    assert sass_loops.main(["--digest", str(f)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert sorted(lines) == sorted(f"{k} sha256 {v}" for k, v in got.items())


def test_fused_timing_onpath_seeds_force_the_tile_through_plan(monkeypatch):
    """--tile reaches the solve through cuda_solve._plan and is undone
    after the runs, whatever the seeds' runs raise."""
    from mppi_robotarm_tpu_torch.ops import cuda_solve

    seen = []

    def fake_simulate(arm, cfg, *a, **k):
        seen.append(cuda_solve._plan(cfg, cfg.num_samples, None, True, True))
        raise RuntimeError("stop")

    monkeypatch.setattr(fused_timing.m, "simulate", fake_simulate)
    plan = cuda_solve._plan
    with pytest.raises(RuntimeError, match="stop"):
        fused_timing.steploop_onpath(torch.device("cpu"), [0], tile=128)
    assert seen == [(128, 8, 1, 1)]
    assert cuda_solve._plan is plan
    with pytest.raises(RuntimeError, match="stop"):
        fused_timing.steploop_onpath(torch.device("cpu"), [0])
    assert seen[1] == (32, 32, 1, 4)       # K=1024's own tile


class _Event:
    def __init__(self, key, total, count):
        self.key, self.self_device_time_total, self.count = key, total, count


def _fake_profiler(monkeypatch, windows):
    """torch.profiler.profile stand-in whose n-th window holds the events
    ``windows[n]``; returns the list that grows by one a window."""
    import torch.profiler

    opened = []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            opened.append(None)
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return windows[len(opened) - 1]

        events = key_averages

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return opened


def test_fused_timing_profiled_us_tries_again_after_an_empty_window(
        monkeypatch):
    """A window that kept no device event is profiled again; the first one
    that kept any gives each kernel's mean a launch, filtered by key."""
    opened = _fake_profiler(monkeypatch, [
        [], [_Event("cpu_op", 0.0, 3)],
        [_Event("solve_tile_kernel<4>", 120.0, 2),
         _Event("other_kernel", 9.0, 3)]])
    calls = []
    got = fused_timing.profiled_us(lambda: calls.append(1), 5,
                                   lambda k: "solve_" in k)
    assert got == {"solve_tile_kernel<4>": 60.0}
    assert len(opened) == 3 and len(calls) == 1 + 3 * 5
    assert fused_timing.PROFILE_TRIES == 3


def test_fused_timing_kernel_device_us_raises_after_every_window_empty(
        monkeypatch):
    opened = _fake_profiler(monkeypatch, [[]] * 3)
    assert fused_timing.profiled_us(lambda: None, 2) == {}
    opened.clear()
    with pytest.raises(RuntimeError, match="no probe_ kernel in 3 windows"):
        fused_timing.kernel_device_us(lambda: None, 2, "probe_")
    assert len(opened) == 3


def test_fused_timing_kernel_device_us_names_a_template_by_its_kernel(
        monkeypatch):
    _fake_profiler(monkeypatch, [[
        _Event("void solve_tile_kernel<4>(SolveParams)", 40.0, 4),
        _Event("void solve_tile_kernel<2>(SolveParams)", 30.0, 3)]])
    assert fused_timing.solve_device_us(lambda: None, 4) == {
        "solve_tile_kernel": 20.0}


def test_overhead_device_launches_tries_again_after_an_empty_window(
        monkeypatch):
    from torch.autograd import DeviceType

    from mppi_robotarm_tpu_torch.tools import overhead

    cpu, cuda = _Event("op", 0.0, 1), _Event("k", 1.0, 1)
    cpu.device_type, cuda.device_type = DeviceType.CPU, DeviceType.CUDA
    opened = _fake_profiler(monkeypatch, [[cpu], [cpu, cuda, cuda],
                                          [cuda, cpu]])
    assert overhead.device_launches(lambda: None) == 2
    assert len(opened) == 2          # the second window saw a launch
    # 4 iterations: 1 event rounds to 0 an iteration, so a second window
    # opens; the third is not needed
    opened = _fake_profiler(monkeypatch, [[cuda], [cuda] * 4, [cuda] * 8])
    assert overhead.device_launches(lambda: None, per=4) == 4
    assert len(opened) == 2
    # three windows at most; the most any of them saw
    opened = _fake_profiler(monkeypatch, [[cuda], [cuda] * 2, [cpu]])
    assert overhead.device_launches(lambda: None, per=8) == 2
    assert len(opened) == 3


def test_sanitize_arguments_and_commands():
    a = sanitize.parse_args([])
    assert a.tool == list(sanitize.TOOLS) and a.case == list(sanitize.CASES)
    assert a.run is None and a.timeout == 600.0
    a = sanitize.parse_args(["--tool", "racecheck", "--case", "k2-1024",
                             "k3-90-prng", "--timeout", "30"])
    cmds = sanitize.commands("/x/compute-sanitizer", a.tool, a.case)
    assert [(t, c) for t, c, _ in cmds] == [("racecheck", "k2-1024"),
                                            ("racecheck", "k3-90-prng")]
    argv = cmds[1][2]
    assert argv[:5] == ["/x/compute-sanitizer", "--tool", "racecheck",
                        "--error-exitcode", "9"]
    assert argv[-4:] == ["-m", "mppi_robotarm_tpu_torch.tools.sanitize",
                         "--run", "k3-90-prng"]
    with pytest.raises(SystemExit):
        sanitize.parse_args(["--case", "k9"])
    with pytest.raises(SystemExit):
        sanitize.parse_args(["--tool", "initcheck"])


def test_sanitize_cases_cover_every_redesigned_kernel():
    assert {c.split("-")[0] for c in sanitize.CASES} == {"k1", "k2", "k3"}
    assert {f"k1-c{c}-{n}" for c in (2, 4, 8) for n in ("eps", "prng")} <= (
        set(sanitize.CASES))
    assert {"k2-1024", "k2-65536"} <= set(sanitize.CASES)


@pytest.mark.parametrize("K,warps", [(128, 4), (90, 2)])
def test_sanitize_fleet_cases_take_the_two_multiwarp_layouts(K, warps):
    """The k3 cases are shapes whose layout the package picks: four warps
    a scenario at K=128, two warps of two samples a lane at K=90."""
    from mppi_robotarm_tpu_torch.ops import cuda_sim

    assert {f"k3-{K}-{n}" for n in ("eps", "prng")} <= set(sanitize.CASES)
    assert cuda_sim.fleet_warps(K) == warps


@pytest.mark.parametrize("out,want", [
    ("========= ERROR SUMMARY: 0 errors\n", 0),
    ("x\n========= ERROR SUMMARY: 3 errors\n", 3),
    ("no summary here", None)])
def test_sanitize_reads_the_error_summary(out, want):
    assert sanitize.summary(out) == want


def _fake_sanitizer(monkeypatch, out, rc):
    import subprocess

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, rc, out, "")

    monkeypatch.setattr(sanitize, "sanitizer_path", lambda: "/x/cs")
    monkeypatch.setattr(sanitize.subprocess, "run", run)
    return calls


def test_sanitize_main_runs_each_tool_and_case(monkeypatch, capsys):
    calls = _fake_sanitizer(monkeypatch, "========= ERROR SUMMARY: 0 errors\n",
                            0)
    assert sanitize.main(["--tool", "memcheck", "synccheck", "--case",
                          "k2-1024", "k1-c8-prng"]) == 0
    assert len(calls) == 4
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "sanitize memcheck k2-1024: rc 0, errors 0"
    calls = _fake_sanitizer(monkeypatch, "========= ERROR SUMMARY: 2 errors\n",
                            9)
    assert sanitize.main(["--tool", "racecheck", "--case", "k2-1024"]) == 1


def test_sanitize_stops_where_the_device_is_not_supported(monkeypatch,
                                                          capsys):
    calls = _fake_sanitizer(
        monkeypatch, "========= Error: Device not supported. Please refer\n",
        9)
    assert sanitize.main([]) == 2
    assert len(calls) == 1
    assert "'Device not supported' on this machine" in (
        capsys.readouterr().out)
    monkeypatch.setattr(sanitize, "sanitizer_path", lambda: None)
    assert sanitize.main([]) == 1


def test_combine_clocks_stamps_fit_the_solve_kernel(monkeypatch):
    """Every stamp's anchor is in csrc/solve_kernel.cu once: a stamp at
    the combine's entry, one after each of its four pieces (the one-tile
    path's end included), so an edit of the combine that moves an anchor
    fails here and not on the card."""
    src = (combine_clocks.PACKAGE / "csrc" / "solve_kernel.cu").read_text()
    out = combine_clocks.instrument(src)
    assert out.count("clock64()") == 6 and "clock64" not in src
    assert out.count("ob[3] = (float)(clock64() - ck") == 2
    with pytest.raises(ValueError, match="anchor"):
        combine_clocks.instrument(src.replace("if (!s_last) return;", ""))
    monkeypatch.setattr(combine_clocks.shutil, "which", lambda name: None)
    assert combine_clocks.main([]) == 1


def test_fused_timing_split_pieces_run_on_the_cpu():
    """--split's pieces (the step kernels' plain versions cut by source,
    the solve, then the two step kernels) run on a small batched state;
    the card only times them."""
    import dataclasses

    from mppi_robotarm_tpu_torch.sim import loop

    arm, cfg, sim = P.benchmark_preset()
    cfg = dataclasses.replace(cfg, num_samples=32, horizon=6)
    ref = torch.as_tensor(P.synth_circle_path(300))
    st = P.init_sim_batch(cfg, sim, [1, 2, 3], device="cpu")
    st, _ = loop._step_loop(arm, cfg, sim, ref, st, 2)
    pieces = fused_timing.split_pieces(arm, cfg, sim, ref, st)
    labels = [label for label, _, _ in pieces]
    assert labels[-2:] == ["step head kernel", "step tail kernel"]
    assert "plant" in labels and "waypoint advance" in labels
    for _, source, fn in pieces:
        assert "::" in source
        fn()


@pytest.mark.parametrize("spec,K,B,want", [
    ("4:1", 1024, 1, (8, 4, 1, 1, 1)), ("2:1", 1024, 1, (16, 2, 1, 0, 1)),
    ("4:8", 128, 4096, (1, 4, 8, 1, 1)), ("2:4", 128, 4096, (2, 2, 4, 0, 1)),
    ("4:1", 4096, 1, None), ("1:1", 128, 1, None), ("4:32", 128, 4096,
                                                     None),
    ("1:1", 65536, 1, (4, 1, 1, 64, 8)), ("1:2", 4096, 3, None),
    ("1:1", 70000, 1, None)])
def test_fused_timing_tail_layout_specs(spec, K, B, want):
    """--tail-layouts L:G: the build with L lanes, its warps and cap from
    the shape, None where the kernel does not take the layout."""
    got = fused_timing.tail_layout_of(spec, K, B)
    assert (None if got is None else tuple(got)) == want


def test_fused_timing_compare_records_field_by_field(tmp_path):
    """--compare-records: equal fields bit for bit, others with their
    largest absolute and relative differences; only seeds in both."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    q = np.arange(6, dtype=np.float32).reshape(3, 2)
    ess = np.array([10.0, 20.0, 40.0], np.float32)
    np.savez(a / "seed0.npz", q=q, ess=ess)
    np.savez(b / "seed0.npz", q=q, ess=ess * np.float32(1.5))
    np.savez(a / "seed1.npz", q=q)
    rows = {r["field"]: r for r in fused_timing.compare_records(str(a),
                                                                str(b))}
    assert set(rows) == {"q", "ess"}
    assert rows["q"]["equal"] and rows["q"]["max_abs"] == 0.0
    assert not rows["ess"]["equal"]
    assert rows["ess"]["max_abs"] == 20.0
    assert abs(rows["ess"]["max_rel"] - 1 / 3) < 1e-12


def test_smoke_ab_stamps_each_line_and_reports_the_marks(tmp_path, capsys):
    trees = {}
    for tag, rc in (("a", 0), ("b", 3)):
        tree = tmp_path / tag
        (tree / "build").mkdir(parents=True)
        (tree / "chip_smoke.py").write_text(
            "import os, sys\n"
            "print('build there:', os.path.isdir('build'))\n"
            f"print('phase 23 done {tag}')\n"
            "print('x', file=sys.stderr)\n"
            f"sys.exit({rc})\n")
        trees[tag] = tree
    out = tmp_path / "out"
    assert smoke_ab.main(["--out", str(out), "--mark", "phase 23",
                          "--mark", "never", f"a={trees['a']}",
                          f"b={trees['b']}"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" in ")[0] for ln in lines] == ["1 a: exit 0",
                                                     "2 b: exit 3"]
    assert all("'never' None" in ln for ln in lines)
    log = (out / "1_a.log").read_text().splitlines()
    stamp, text = log[1].split("\t")
    assert float(stamp) >= 0 and text == "phase 23 done a"
    assert log[0].endswith("\tbuild there: False")   # each run builds anew
    assert (out / "2_b.err").read_text() == "x\n"
    b23 = smoke_ab.mark_stamps(str(out / "2_b.log"), ["phase 23"])[0]
    assert b23 == float((out / "2_b.log").read_text().splitlines()[1]
                        .split("\t")[0])
    assert f"'phase 23' {b23}" in lines[1]


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def test_call_graphs_tool_compares_on_the_cpu(
        replaying_capture, counted_kernels, monkeypatch):  # noqa: F811
    """``tools/call_graphs.py`` at small sizes, the per-call graphs on CPU
    tensors under the stand-in: the drop-in's graph run against its
    uncaptured run, every field 0.0 (bitwise), and a perturbed or shorter
    run showing its difference; a solve chain and a ``solve_batched``
    chain bitwise with one capture each."""
    monkeypatch.setattr(call_graphs, "_events_ms", _host_ms)
    monkeypatch.setattr(call_graphs, "_reserved_by", lambda fn: fn() and 0)
    got = call_graphs.compat_run("eager", "cpu", 4, True)
    assert sorted(call_graphs.captures()) == ["solve", "viz_rollouts"]
    want = call_graphs.compat_run("eager", "cpu", 4, False)
    assert len(got) == 4
    assert set(call_graphs.compat_bits(got, want).values()) == {0.0}
    bumped = [(r[0] + 1e-3, *r[1:]) for r in got]
    d = call_graphs.compat_bits(bumped, want)
    assert d["u0"] == pytest.approx(1e-3) and d["u_seq"] == 0.0
    assert call_graphs.compat_bits(got[:3], want)["calls"] == 1.0

    arm = P.ArmParams()
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=16, horizon=5)
    ref = torch.as_tensor(P.synth_circle_path(2000))
    x0 = torch.tensor([1.1522, -1.2661, 0.0, 0.0])
    state = P.init_state(cfg, device="cpu")
    eps = [torch.randn((16, 5, 2), generator=torch.Generator().manual_seed(i))
           for i in range(4)]
    row = call_graphs.chain_check(
        "solve", lambda n: call_graphs.solve_chain(arm, cfg, ref, x0, state,
                                                   eps[:n]), calls=4,
        rounds=1)
    assert set(row["diffs"].values()) == {0.0} and len(row["diffs"]) > 5
    assert list(row["captures"]) == ["solve"] and row["reserved"] == 0
    states = P.init_sim_batch(cfg, P.SimConfig(), [0, 1], device="cpu")
    xb = torch.cat([states.q, states.dq], dim=-1)
    row = call_graphs.chain_check(
        "solve_batched", lambda n: call_graphs.batched_chain(
            arm, cfg, ref, xb, states.mppi, states.seed, n), calls=3,
        rounds=1)
    assert set(row["diffs"].values()) == {0.0}
    assert list(row["captures"]) == ["solve_batched"]
