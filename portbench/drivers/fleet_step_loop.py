"""Traffic: back-to-back chains of ``simulate_batch(backend="cuda")`` over
a fleet of scenarios, the per-step loop the command line's ``--batch B``
runs with its default ``--backend cuda``: replayed CUDA graphs of a chunk
of steps, each step one step head (S1), one solve (K2) and one step tail
(S2) for the whole fleet, so any K is served and the state is the
caller's after every chain.

Set-up draws the fleet's initial states once from ``--seed``, as
``fleet_chain`` does: the configuration's q0 plus ``q0_spread``·N(0, 1)
per scenario and joint.  Each chain starts every scenario from its
initial state with a Philox seed of its own, drawn from ``--seed``, the
chain's index and the scenario's, and runs ``chain_steps`` steps;
set-up's warm-up chain captures the graphs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import chains, inputs, program

KIND = chains.KIND
window = chains.window
cases = chains.cases


def prepare(cell, seed: int, device: torch.device) -> chains.ChainProgram:
    P = cell.conf
    B = P["fleet"]["scenarios"]
    q0 = (np.asarray(P["sim"]["q0"])[None] + P["fleet"]["q0_spread"]
          * inputs.rng(seed, 1).standard_normal((B, 2))).astype(np.float32)

    def make(arm, cfg, sim, ref):
        def start(c: int):
            return program.port.init_sim_batch(
                cfg, sim, inputs.seeds(seed, c, B), q0=q0, device=device)

        def run(states, n: int):
            return program.port.simulate_batch(arm, cfg, sim, ref, states,
                                               n, backend="cuda")
        return start, run
    return chains.prepare(cell, seed, device, make, batched=True)
