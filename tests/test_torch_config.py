"""The port's config copy equals the JAX package's, and the port never
imports JAX."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest

import mppi_robotarm_tpu.config as jcfg
import mppi_robotarm_tpu_torch.config as pcfg
import _torch_port_helpers  # noqa: F401  (pins torch to one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("preset", ["circle_tracking_preset",
                                    "benchmark_preset",
                                    "high_accuracy_preset"])
def test_presets_equal_jax(preset):
    jax_side = getattr(jcfg, preset)()
    port_side = getattr(pcfg, preset)()
    for j, p in zip(jax_side, port_side):
        assert type(j).__name__ == type(p).__name__
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert jax_side[1].gamma == port_side[1].gamma


@pytest.mark.parametrize("cls", ["ArmParams", "MPPIConfig", "SimConfig"])
def test_dataclass_fields_equal_jax(cls):
    jf = dataclasses.fields(getattr(jcfg, cls))
    pf = dataclasses.fields(getattr(pcfg, cls))
    assert [(f.name, f.default) for f in jf] == \
        [(f.name, f.default) for f in pf]


def test_json_round_trip_and_cross_load():
    arm, cfg, sim = pcfg.benchmark_preset()
    cfg = dataclasses.replace(cfg, u_clamp=0.8, exploration=0.1)
    text = pcfg.config_to_json(arm, cfg, sim)
    assert pcfg.config_from_json(text) == (arm, cfg, sim)
    # the two packages read each other's JSON
    jarm, jmppi, jsim = jcfg.config_from_json(text)
    assert dataclasses.asdict(jmppi) == dataclasses.asdict(cfg)
    assert pcfg.config_to_json(arm, cfg, sim) == \
        jcfg.config_to_json(jarm, jmppi, jsim)


def test_validate_rejects_bad_sigma():
    with pytest.raises(ValueError, match="sigma"):
        dataclasses.replace(pcfg.MPPIConfig(),
                            sigma=((1.0, 0.0, 0.0),)).validate()
    with pytest.raises(ValueError, match="filter_window"):
        dataclasses.replace(pcfg.MPPIConfig(), filter_window=0).validate()


def test_port_never_imports_jax():
    """Every module of the port, found by walking the package, imports in
    one process with neither JAX nor the JAX package loaded."""
    code = ("import importlib, pkgutil, sys\n"
            "import mppi_robotarm_tpu_torch as port\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    port.__path__, port.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'mppi_robotarm_tpu'))\n"
            "assert not bad, bad\n"
            "print(len(names), ' '.join(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, names = proc.stdout.split(None, 1)
    for name in ("bench", "tools.bench_gate_sweep", "tools.seed_sweep",
                 "tools.extreme_shapes", "tools.longrun", "parallel.sharded",
                 "ops.cuda_shard", "ops.cuda_pathgen", "sim.pathgen",
                 "compat", "tools.collective_cost"):
        assert f"mppi_robotarm_tpu_torch.{name}" in names.split(), name
    assert int(count) >= 40, names


def test_root_exports_everything_the_jax_root_does():
    """The port's ``__all__`` holds every name of the JAX package's, read
    from the JAX file's text (importing it would import JAX), and each
    name resolves at the port's root."""
    import mppi_robotarm_tpu_torch as port

    with open(os.path.join(REPO, "mppi_robotarm_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__"
                           for t in node.targets))
    assert "generate_circle_path" in jax_all and "save_path_file" in jax_all
    assert set(jax_all) <= set(port.__all__), sorted(
        set(jax_all) - set(port.__all__))
    for name in port.__all__:
        assert hasattr(port, name), name
    from mppi_robotarm_tpu_torch import (  # noqa: F401
        generate_circle_path, save_path_file)
