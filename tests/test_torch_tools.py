"""The port's measurement tools on the CPU: ``tools/sass_loops.py`` on a
saved SASS listing in ``cuobjdump -sass``'s format, and the parts of
``tools/fused_timing.py`` that need no card (the launch settings, the
fingerprint and the on-path mean)."""

import numpy as np
import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import cuda_sim
from mppi_robotarm_tpu_torch.tools import fused_timing, sass_loops

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
