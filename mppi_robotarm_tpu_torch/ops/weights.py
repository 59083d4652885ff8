"""Information-theoretic MPPI weights (reference control.py:297-314).

ρ = min S, wₖ = exp(−(Sₖ−ρ)/λ) / Σ exp(−(Sⱼ−ρ)/λ): a stabilised softmax
over −S/λ, plus the solver-health metrics of the weights.  The sharded
solve (``parallel/sharded.py``) splits the softmax across sample shards with
:func:`local_exp_terms`.
"""

from __future__ import annotations

import torch


def mppi_weights(s: torch.Tensor, lam: float) -> torch.Tensor:
    """wₖ = softmax(−(Sₖ − min S)/λ) over the last axis."""
    rho = torch.amin(s, dim=-1, keepdim=True)
    e = torch.exp(-(s - rho) / lam)
    return e / torch.sum(e, dim=-1, keepdim=True)


def local_exp_terms(s_local: torch.Tensor, rho_global, lam: float):
    """Shard-local numerators exp(−(Sₖ − ρ)/λ) and their partial η (summed
    over the last axis, kept) given the global ρ, which comes from a MIN
    all-reduce over the 'samples' axis; η is then a SUM of the partials."""
    e = torch.exp(-(s_local - rho_global) / lam)
    return e, torch.sum(e, dim=-1, keepdim=True)


def effective_sample_size(w: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / Σ wₖ²."""
    return 1.0 / torch.sum(w * w, dim=-1)


def weight_entropy(w: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the weight distribution."""
    return -torch.sum(
        torch.where(w > 0, w * torch.log(torch.clamp_min(w, 1e-38)), 0.0),
        dim=-1)
