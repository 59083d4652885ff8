"""sim_kernel's launch settings, on the CPU: the choice of blocks per
scenario (``cuda_sim.cluster_size``), the ``cluster`` keyword's checks, the
C declarations in ``csrc/`` against their ``ctypes`` bindings (the structs'
fields and the functions' arguments), and the launch's arguments as the
wrapper passes them, through a stand-in for the library; the same for the
solve kernel's one launch and its arrival counters.  The kernels
themselves (sim_kernel at every cluster size against ``cluster=1``, the
solve against its plain version, in graphs and on two streams) are tested
on the card (``tests/test_torch_cuda.py``)."""

import contextlib
import ctypes
import dataclasses
import re
import types
from pathlib import Path

import pytest
import torch

import mppi_robotarm_tpu_torch as P
from mppi_robotarm_tpu_torch.ops import _build, cuda_sim, cuda_solve

CSRC = Path(cuda_sim.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132


@pytest.mark.parametrize("B,K,want", [
    (1, 1024, 8),         # benchmark_preset: the main path, 4 warps a block
    (1, 100, 1),          # circle_tracking_preset: 4 warps in all
    (1, 8192, 8),         # large K: still a 1024-thread virtual block
    (4096, 128, 1),       # the fleet at group=1 keeps one block a scenario
    (4096, 1024, 1),
    (16, 1024, 8),        # 128 of 132 SMs
    (17, 1024, 4),
    (33, 1024, 4),        # exactly 132
    (34, 1024, 2),
    (67, 1024, 1),        # 2 x 67 > 132
    (1, 512, 4),
    (1, 256, 2),
    (1, 96, 1),           # 3 warps
    (1, 1, 1),
])
def test_cluster_size_cases(B, K, want):
    assert cuda_sim.cluster_size(B, K, H100_SMS) == want


@pytest.mark.parametrize("sms", [132, 114, 16, 1])
def test_cluster_size_splits_whole_warps_within_the_card(sms):
    for B in (1, 2, 3, 5, 8, 16, 17, 33, 66, 100, 4096):
        for K in (1, 31, 32, 33, 64, 96, 100, 128, 160, 256, 500, 1000,
                  1024, 1025, 4096, 8192):
            nwarp = cuda_sim.sim_threads(K) // 32
            c = cuda_sim.cluster_size(B, K, sms)
            fits = [d for d in cuda_sim.CLUSTER_SIZES
                    if nwarp % d == 0 and B * d <= sms
                    and nwarp // d >= cuda_sim.CTA_MIN_WARPS]
            assert c in cuda_sim.CLUSTER_SIZES
            assert c <= nwarp and nwarp % c == 0
            assert c == 1 or (B * c <= sms
                              and nwarp // c >= cuda_sim.CTA_MIN_WARPS)
            assert c == max(fits, default=1)     # the largest that fits


def test_cluster_sizes_match_the_kernel_limit():
    """The wrapper offers the sizes the launcher accepts: powers of two up
    to the kernel's kMaxCluster, the portable limit."""
    src = (CSRC / "sim_kernel.cu").read_text()
    limit = int(re.search(r"constexpr int kMaxCluster = (\d+);",
                          src).group(1))
    assert limit == 8 == max(cuda_sim.CLUSTER_SIZES)
    assert sorted(cuda_sim.CLUSTER_SIZES) == [1, 2, 4, 8]
    assert "NonPortableClusterSizeAllowed" not in src


def test_sim_threads_is_the_virtual_block():
    assert [cuda_sim.sim_threads(k) for k in (1, 32, 33, 100, 1024, 1025,
                                              8192)] == [32, 32, 64, 128,
                                                         1024, 1024, 1024]


def _cpu_args(cfg, steps=2, B=1):
    ref = torch.as_tensor(P.synth_circle_path(400))
    q0 = torch.tensor([P.SimConfig().q0] * B, dtype=torch.float32)
    u = torch.tensor(cfg.warm_start, dtype=torch.float32).repeat(
        B, cfg.horizon, 1).contiguous()
    return (P.ArmParams(), cfg, P.SimConfig(), ref, q0,
            torch.zeros(B, 2), u, torch.zeros(B, dtype=torch.int64),
            torch.arange(B) + 3, steps)


def test_cluster_keyword_is_checked_on_the_cpu_path_too():
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=100, horizon=6)
    args = _cpu_args(cfg)
    before = cuda_sim.LAUNCHES
    plain = cuda_sim.fused_sim_run_batched(*args)
    for c in (1, 2, 4):       # a launch setting: the plain version ignores it
        got = cuda_sim.fused_sim_run_batched(*args, cluster=c)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert cuda_sim.LAUNCHES == before
    for bad in (3, 8, 32, 0):  # not a size, or 8 does not divide 4 warps
        with pytest.raises(ValueError, match="cluster"):
            cuda_sim.fused_sim_run_batched(*args, cluster=bad)
    big = _cpu_args(dataclasses.replace(cfg, num_samples=1024))
    with pytest.raises(ValueError, match="cluster"):   # beyond the portable 8
        cuda_sim.fused_sim_run_batched(*big, cluster=16)
    fleet = dataclasses.replace(cfg, num_samples=64)
    with pytest.raises(ValueError, match="fleet_kernel"):
        cuda_sim.fused_sim_run_batched(*_cpu_args(fleet, B=2), group=2,
                                       cluster=2)


def _struct_fields(source: str, name: str):
    """(field, C type, array length) of ``struct name`` in a C source."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    out = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for v in names.split(","):
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", v.strip())
            out.append((m.group(1), ctype, int(m.group(2) or 0)))
    return out


def _ctypes_fields(struct):
    out = []
    for name, ct in struct._fields_:
        length = getattr(ct, "_length_", 0)
        base = ct._type_ if length else ct
        ctype = {ctypes.c_float: "float", ctypes.c_int: "int"}.get(
            base, base.__name__.lstrip("_"))
        out.append((name, ctype, length))
    return out


@pytest.mark.parametrize("struct,header,c_name", [
    (cuda_sim._SimParams, "sim_common.cuh", "SimParams"),
    (cuda_solve._SolveParams, "solve_kernel.cu", "SolveParams"),
    (cuda_sim._ArmConsts, "mppi_device.cuh", "ArmConsts"),
])
def test_ctypes_mirrors_match_the_c_structs(struct, header, c_name):
    """The loader checks only the sizes; here the fields, in order."""
    want = _struct_fields((CSRC / header).read_text(), c_name)
    assert _ctypes_fields(struct) == want


def _c_functions():
    """name -> (return type, [parameter types]) of every extern "C"
    function defined in csrc/*.cu."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        block = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^(const char\*|int) (mppi_\w+)\(([^)]*)\)",
                             block, re.M):
            params = [p.strip() for p in m.group(3).split(",") if p.strip()]
            out[m.group(2)] = (m.group(1), params)
    return out


def test_c_functions_match_their_ctypes_declarations():
    decls = _c_functions()
    assert set(decls) == set(_build.C_FUNCTIONS)
    ret_map = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}
    for name, (ret, params) in decls.items():
        argtypes, restype = _build.C_FUNCTIONS[name]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_float
                if p.startswith("float ") else ctypes.c_int for p in params]
        assert argtypes == want, name
        assert restype is ret_map[ret], name


class _FakeLib:
    """Stands in for the built library: checks each call against the
    declared argtypes and records it."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        argtypes, _ = _build.C_FUNCTIONS[name]

        def call(*args):
            assert len(args) == len(argtypes), name
            for a, ct in zip(args, argtypes):
                if ct is ctypes.c_int:
                    assert isinstance(a, int), (name, a)
                else:
                    assert a is None or isinstance(
                        a, (ctypes.c_void_p, ctypes._Pointer,
                            type(ctypes.byref(ctypes.c_int())))), (name, a)
            self.calls.append((name, args))
            return b"cluster cannot be placed" if name == "mppi_error_string" \
                else self.err
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The CUDA calls around a launch, answered as a 132-SM card would."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            multi_processor_count=H100_SMS))

    def use(lib):
        monkeypatch.setattr(_build, "load_library", lambda: lib)
        return lib
    return use


@pytest.mark.parametrize("K,B,cluster,want", [(1024, 1, None, 8),
                                              (100, 2, None, 1),
                                              (1024, 1, 4, 4),
                                              (512, 2, None, 4),
                                              (128, 4096, None, 1)])
@pytest.mark.parametrize("noise", ["prng", "eps"])
def test_launch_passes_the_cluster_and_the_scratch(fake_card, K, B, cluster,
                                                   want, noise):
    lib = fake_card(_FakeLib())
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=5)
    args = list(_cpu_args(cfg, steps=1, B=B))
    eps = (torch.zeros(B, 1, K, 5, 2) if noise == "eps" else None)
    before = cuda_sim.LAUNCHES
    rec, ufin = cuda_sim._launch(*args, eps, torch.zeros(B, dtype=torch.int64),
                                 cluster)
    assert cuda_sim.LAUNCHES == before + 1
    assert rec.shape == (B, 1, 12) and ufin.shape == (B, 5, 2)
    (name, a), = lib.calls
    assert name == "mppi_sim_launch" and a[1:3] == (B, want)
    eps_ptr, scratch_ptr = a[7], a[8]
    assert (eps_ptr is None) == (noise == "prng")
    assert (scratch_ptr is None) == (noise == "eps")


def test_launch_rejects_a_misaligned_path(fake_card):
    lib = fake_card(_FakeLib())
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=64, horizon=5)
    args = list(_cpu_args(cfg, steps=1))
    args[3] = torch.zeros(101 * 4)[1:401].view(100, 4)   # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        cuda_sim._launch(*args, None, torch.zeros(1, dtype=torch.int64), 1)
    assert not lib.calls


def test_launch_error_raises_with_the_cluster(fake_card):
    fake_card(_FakeLib(err=912))
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=1024, horizon=5)
    before = cuda_sim.LAUNCHES
    with pytest.raises(RuntimeError, match="cluster of 8 blocks.*placed"):
        cuda_sim._launch(*_cpu_args(cfg, steps=1), None,
                         torch.zeros(1, dtype=torch.int64), None)
    assert cuda_sim.LAUNCHES == before


# ---- the solve kernel's launch (csrc/solve_kernel.cu) ----------------------

@pytest.fixture
def fresh_counters(monkeypatch):
    monkeypatch.setattr(cuda_solve, "_COUNTERS", {})
    monkeypatch.setattr(cuda_solve, "_FREE_COUNTERS", {})


def _solve_cpu_args(cfg, B):
    x0 = torch.tensor([[1.15, -1.27, 0.1, -0.2]] * B)
    u = torch.tensor(cfg.warm_start, dtype=torch.float32).repeat(
        B, cfg.horizon, 1).contiguous()
    win = torch.as_tensor(P.synth_circle_path(400))[None, :cfg.search_idx_len]
    return x0, u, win.repeat(B, 1, 1).contiguous()


@pytest.mark.parametrize("K,B,n_tiles", [(1024, 1, 32), (1024, 64, 32),
                                         (65536, 1, 128), (100, 8, 1),
                                         (128, 4096, 1)])
def test_solve_launch_is_one_call_with_the_streams_counters(
        fake_card, fresh_counters, K, B, n_tiles):
    """One C call a solve, counted once in LAUNCHES; a scenario of one
    tile gets no workspace (the kernel
    combines it in shared memory); every launch on a stream gets that
    stream's zeroed counters."""
    lib = fake_card(_FakeLib())
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=5)
    before = cuda_solve.LAUNCHES
    out, s, eps, (m, eta) = cuda_solve._launch(
        P.ArmParams(), cfg, *_solve_cpu_args(cfg, B), torch.arange(B), None,
        None, None, False, True, True, None, None)
    assert cuda_solve.LAUNCHES == before + 1
    assert out.shape == (B, 5, 2) and s.shape == (B, K) and eps is None
    (name, a), = lib.calls
    assert name == "mppi_solve_launch" and a[1] == B
    assert a[0]._obj.n_tiles == n_tiles
    part, count = a[11], a[12]
    assert (part is None) == (n_tiles == 1)
    counters = cuda_solve._COUNTERS[(None, 7)]
    assert count.value == counters.data_ptr() and not counters.any()
    cuda_solve._launch(P.ArmParams(), cfg, *_solve_cpu_args(cfg, B),
                       torch.arange(B), None, None, None, False, True, True,
                       None, None)
    assert lib.calls[1][1][12].value == count.value      # the same slot


@pytest.mark.parametrize("K,B,n_tiles", [(1024, 1, 32), (1024, 64, 32),
                                         (65536, 1, 128), (100, 8, 1),
                                         (128, 4096, 1)])
def test_solve_launch_counts_its_tile_partials(fake_card, fresh_counters, K,
                                               B, n_tiles):
    """A launch adds the partials its combine folds, n_tiles × B, to
    PARTIALS, beside its one launch in LAUNCHES."""
    fake_card(_FakeLib())
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=5)
    before = (cuda_solve.LAUNCHES, cuda_solve.PARTIALS)
    cuda_solve._launch(P.ArmParams(), cfg, *_solve_cpu_args(cfg, B),
                       torch.arange(B), None, None, None, False, True, True,
                       None, None)
    assert (cuda_solve.LAUNCHES, cuda_solve.PARTIALS) == (
        before[0] + 1, before[1] + n_tiles * B)


# ---- the compiled-width window scan (cuda_sim.scan_width) ----------------

@pytest.mark.parametrize("W,lanes,want", [
    (30, 1, 30),          # every configuration's window, one lane a sample
    (30, 2, 0), (30, 4, 0),   # the lanes that split a scan keep the loop
    (7, 1, 0), (33, 1, 0), (29, 1, 0), (31, 1, 0), (1, 1, 0)])
def test_scan_width_is_the_compiled_width_at_one_lane(W, lanes, want):
    assert cuda_sim.scan_width(W, lanes) == want
    assert cuda_sim.scan_width(W) == (W if W == cuda_sim.SCAN_WIDTH else 0)


def test_scan_width_is_the_width_the_kernels_compile():
    """The wrappers' width is the kernels' kScanWidth, the reference's
    default window."""
    src = (CSRC / "mppi_device.cuh").read_text()
    width = int(re.search(r"constexpr int kScanWidth = (\d+);",
                          src).group(1))
    assert width == cuda_sim.SCAN_WIDTH == P.MPPIConfig().search_idx_len


@pytest.mark.parametrize("K,B,W,sms,want", [
    (65536, 1, 30, 132, 30),    # the large-K cell: one lane a sample
    (128, 64, 30, 132, 0),      # a fleet-like batch at two lanes
    (128, 256, 30, 132, 30),    # and at one
    (1024, 1, 30, 132, 0),      # four lanes a sample: the loop
    (1024, 8, 30, 132, 0),      # two lanes
    (1024, 64, 30, 132, 30),    # one lane
    (65536, 1, 7, 132, 0), (65536, 1, 33, 132, 0),
    (100, 8, 30, None, 30)])    # no card: one lane
def test_solve_launch_hands_the_kernel_its_scan_width(
        fake_card, fresh_counters, monkeypatch, K, B, W, sms, want):
    """The solve's one C call carries ``scan_width(W, lanes)`` of its
    layout, and a launch on the compiled width counts in COMPILED_SCANS
    beside LAUNCHES."""
    lib = fake_card(_FakeLib())
    monkeypatch.setattr(cuda_solve, "_sm_count", lambda d: sms)
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=K, horizon=5,
                              search_idx_len=W)
    x0, u, win = _solve_cpu_args(cfg, B)
    before = (cuda_solve.LAUNCHES, cuda_solve.COMPILED_SCANS)
    cuda_solve._launch(P.ArmParams(), cfg, x0, u, win, torch.arange(B),
                       None, None, None, False, True, True, None, None)
    (name, a), = lib.calls
    assert name == "mppi_solve_launch" and a[-2] == want
    assert a[0]._obj.W == W
    assert want == 0 or a[0]._obj.lanes == 1
    assert (cuda_solve.LAUNCHES, cuda_solve.COMPILED_SCANS) == (
        before[0] + 1, before[1] + bool(want))


@pytest.mark.parametrize("W,want", [(30, 30), (7, 0), (33, 0)])
def test_fleet_launch_hands_the_kernel_its_scan_width(fake_card, W, want):
    """fleet_kernel scans one sample a lane: the compiled width wherever W
    is one, counted in FLEET_COMPILED_SCANS beside FLEET_LAUNCHES."""
    lib = fake_card(_FakeLib())
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=128, horizon=5,
                              search_idx_len=W)
    args = list(_cpu_args(cfg, steps=1, B=8))
    before = (cuda_sim.FLEET_LAUNCHES, cuda_sim.FLEET_COMPILED_SCANS)
    cuda_sim._launch_fleet(*args, None, torch.zeros(8, dtype=torch.int64), 8)
    calls = [c for c in lib.calls if c[0] == "mppi_fleet_launch"]
    (name, a), = calls
    assert a[1:5] == (8, 8, 4, want)
    assert (cuda_sim.FLEET_LAUNCHES, cuda_sim.FLEET_COMPILED_SCANS) == (
        before[0] + 1, before[1] + bool(want))


def test_solves_inside_counters_of_take_that_streams_slot(fake_card,
                                                           fresh_counters):
    """Inside ``counters_of(device, 9, on=7)`` a launch on stream 7 takes
    stream 9's counters (a graph captured on a side stream for replay on
    stream 9); outside it, its own again."""
    lib = fake_card(_FakeLib())
    cfg = dataclasses.replace(P.MPPIConfig(), num_samples=1024, horizon=5)
    launch = lambda: cuda_solve._launch(
        P.ArmParams(), cfg, *_solve_cpu_args(cfg, 1), torch.arange(1), None,
        None, None, False, True, True, None, None)
    with cuda_solve.counters_of(torch.device("cpu"), 9, 7):
        launch()
    launch()
    (_, inside), (_, outside) = lib.calls
    assert inside[12].value == cuda_solve._COUNTERS[(None, 9)].data_ptr()
    assert outside[12].value == cuda_solve._COUNTERS[(None, 7)].data_ptr()
    assert inside[12].value != outside[12].value
    assert not cuda_solve._COUNTERS_OF

def test_arrival_counters_give_each_stream_its_own_zeroed_slot(
        fresh_counters):
    dev = torch.device("cpu")
    a, b = (cuda_solve._arrival_counters(dev, st) for st in (7, 9))
    assert a.shape == (cuda_solve.MAX_SCENARIOS,) and a.dtype == torch.int32
    assert not a.any() and not b.any()
    assert cuda_solve._arrival_counters(dev, 7) is a
    assert a.data_ptr() != b.data_ptr()
    # one allocation serves COUNTER_SLOTS streams; the next takes another
    more = [cuda_solve._arrival_counters(dev, st)
            for st in range(100, 100 + cuda_solve.COUNTER_SLOTS)]
    slots = [a, b, *more]
    assert len({t.data_ptr() for t in slots}) == len(slots)
    base = a.untyped_storage().data_ptr()
    n = cuda_solve.COUNTER_SLOTS
    assert [t.untyped_storage().data_ptr() == base for t in slots] == (
        [True] * n + [False] * 2)


def test_arrival_counters_are_not_allocated_during_a_capture(
        monkeypatch, fresh_counters):
    """A capture takes a free slot, but allocating one there would come
    from the graph's pool, zeroed only when the graph replays: it raises."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    dev = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="uncaptured call"):
        cuda_solve._arrival_counters(dev, 5)
    spare = torch.zeros(cuda_solve.MAX_SCENARIOS, dtype=torch.int32)
    cuda_solve._FREE_COUNTERS[0] = [spare]
    assert cuda_solve._arrival_counters(dev, 5) is spare
