"""Traffic: back-to-back chains of ``simulate_fused_batch`` over a fleet of
scenarios, the whole closed loop of every scenario in one launch: K3
(``csrc/fleet_kernel.cu``) at K <= 128, as the entry picks its group.

Set-up draws the fleet's initial states once from ``--seed``: the
configuration's q0 plus ``q0_spread``·N(0, 1) per scenario and joint.
Each chain starts every scenario from its initial state with a Philox
seed of its own, drawn from ``--seed``, the chain's index and the
scenario's, and runs ``chain_steps`` steps.
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
            return program.port.simulate_fused_batch(arm, cfg, sim, ref,
                                                     states, n)
        return start, run
    return chains.prepare(cell, seed, device, make, batched=True)
