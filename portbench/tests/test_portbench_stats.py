"""The yardstick's arithmetic: rates and tails over everything in a window,
device busy and idle from one trace, and roofline counts from the shapes
alone."""

import json
from pathlib import Path

import pytest

from mppi_robotarm_tpu_torch.ops import cuda_sim, cuda_solve
from portbench import roofline, stats, trace

ROOT = Path(__file__).resolve().parents[2]


def test_rate_is_all_work_over_all_time_and_a_stall_moves_it():
    chains = [0.25] * 40                       # seconds a chain
    work = 4000 * len(chains)
    steady = stats.rate(work, 0.0, sum(chains))
    stalled = chains[:20] + [0.25 + 1.0] + chains[21:]
    assert stats.rate(work, 0.0, sum(stalled)) < 0.97 * steady
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)


def test_p95_is_over_every_call_and_a_stall_moves_it():
    calls = [0.4e-3] * 1000
    assert stats.percentile(calls, 95) == 0.4e-3
    stalled = list(calls)
    for i in range(500, 560):                  # one 60-call stall
        stalled[i] = 2.0e-3
    assert stats.percentile(stalled, 95) == 2.0e-3
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5
    assert stats.percentile([5, 1, 4, 2, 3], 40) == 2


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4
    assert stats.gaps(iv, -1, 8) == [(-1, 0, 0), (3, 5, 2), (6, 8, None)]


class _Event:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_trace_busy_idle_and_breakdown_come_from_one_window():
    ev = [_Event("cudaLaunchKernel", "DeviceType.CPU", 0, 10),
          _Event("void sim_kernel<8>(SimParams, float const*)",
                 "DeviceType.CUDA", 20, 600),
          _Event("Memcpy DtoH (Device -> Pinned)", "DeviceType.CUDA", 700,
                 50),
          _Event("cudaDeviceSynchronize", "DeviceType.CPU", 600, 400)]
    tr = trace.from_events(ev)
    assert tr.span == (0, 1000)
    assert tr.kernel("sim_kernel") == (pytest.approx(600e-9), 1)
    assert tr.busy_s == pytest.approx(650e-9)
    assert tr.idle_share() == pytest.approx(0.35)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["sim_kernel", pytest.approx(600e-9)]
    assert dict(map(tuple, b["idle_gaps"])) == pytest.approx({
        "host, then sim_kernel": 20e-9, "host, then Memcpy DtoH": 80e-9,
        "host, to the end of the window": 250e-9})


def test_short_names():
    assert trace.short_name("void fleet_kernel<4, 2>(SimParams, int)") == \
        "fleet_kernel"
    assert trace.short_name("solve_tile_kernel(SolveParams const, float*)") \
        == "solve_tile_kernel"
    assert trace.short_name(
        "void at::native::vectorized_elementwise_kernel<4>(int)") == \
        "vectorized_elementwise_kernel"
    assert trace.short_name("Memset (Device)") == "Memset"


def _mp(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json")
                      .read_text())["mppi"]


def test_roofline_counts_read_the_shapes_alone(monkeypatch):
    mp = _mp("arm_k1024_h50")
    k1 = roofline.loop_bound_s(mp, 8000, 4000, 1, 1)
    k2 = roofline.solve_bound_s(mp, 4000)
    # the port's launch plans changed: the counts stay
    monkeypatch.setattr(cuda_solve, "_plan", lambda *a, **k: (7, 3, 1, 1))
    monkeypatch.setattr(cuda_sim, "cluster_size", lambda *a, **k: 1)
    monkeypatch.setattr(cuda_solve, "TILE_SMS", 1)
    assert roofline.loop_bound_s(mp, 8000, 4000, 1, 1) == k1
    assert roofline.solve_bound_s(mp, 4000) == k2
    assert k1[1] == k2[1] == "operations"
    # a K1 step at K=1024, H=50 is about 0.3 µs of the card's peak
    assert 0.29e-6 < k1[0] / 4000 < 0.31e-6
    fleet = roofline.loop_bound_s(_mp("fleet4096_k128_t30"), 2000,
                                  4096 * 256, 1, 4096)
    assert 90e-6 < fleet[0] / 256 < 95e-6
