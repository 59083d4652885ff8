"""Traffic: back-to-back chains of ``simulate(backend="cuda")``, the
per-step loop the command line's ``--backend cuda`` runs: replayed CUDA
graphs of a chunk of steps, each step the step head (S1), the solve (K2)
and the step tail (S2).

Each chain starts from the configuration's initial state with a Philox
seed of its own, drawn from ``--seed`` and the chain's index, and runs
``chain_steps`` steps; set-up's warm-up chain captures the graphs.
"""

from __future__ import annotations

import torch

from portbench import chains, inputs, program

KIND = chains.KIND
window = chains.window
cases = chains.cases


def prepare(cell, seed: int, device: torch.device) -> chains.ChainProgram:
    def make(arm, cfg, sim, ref):
        def start(c: int):
            return program.port.init_sim(cfg, sim, seed=int(
                inputs.seeds(seed, c, 1)[0]), device=device)

        def run(state, n: int):
            return program.port.simulate(arm, cfg, sim, ref, state, n,
                                         backend="cuda")
        return start, run
    return chains.prepare(cell, seed, device, make, batched=False)
