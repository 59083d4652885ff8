"""The port's measurement tools on the CPU: ``tools/sass_loops.py`` on
saved listings in ``cuobjdump -sass``'s and ``nvdisasm -gi``'s formats, the
parts of ``tools/fused_timing.py`` that need no card (the launch settings
of its three modes, the fingerprint and the on-path mean), and the
argument handling of ``tools/sanitize.py``."""

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_sim
from mppi_robotarm_tpu_torch.tools import fused_timing, sanitize, sass_loops

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
    H100; then the large-K solve and the fleet's per-step solve."""
    assert [s[1:] for s in fused_timing.solve_shapes()] == [
        (1, 1024, 50), (8, 1024, 50), (64, 1024, 50), (1, 65536, 50),
        (4096, 128, 30)]


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
