"""Information-theoretic MPPI weights (reference control.py:297-314).

ρ = min S, wₖ = exp(−(Sₖ−ρ)/λ) / Σ exp(−(Sⱼ−ρ)/λ): a stabilised softmax
over −S/λ, plus the solver-health metrics of the weights.  Their sums over
the samples run in an order fixed by K alone (:func:`ordered_sum`), so a
scenario's weights have the same bits in a batch of any size, on the card
too.  The sharded solve (``parallel/sharded.py``) splits the softmax
across sample shards with :func:`local_exp_terms`.
"""

from __future__ import annotations

import torch


def ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Σ over ``dim`` in an order that depends on that axis's length alone,
    so each row's sum has the same bits in a batch of any size.  On the
    CPU that is ``torch.sum``'s own, sample by sample along the axis; on
    the card, whose reductions pick their order by the tensor's shape, a
    pairwise tree of elementwise adds: the axis padded with zeros to a
    power of two, then halved, each half added to the other, until one
    element is left."""
    if not x.is_cuda:
        return torch.sum(x, dim=dim)
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    width = 1 << max(0, n - 1).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def mppi_weights(s: torch.Tensor, lam: float) -> torch.Tensor:
    """wₖ = softmax(−(Sₖ − min S)/λ) over the last axis."""
    rho = torch.amin(s, dim=-1, keepdim=True)
    e = torch.exp(-(s - rho) / lam)
    return e / ordered_sum(e)[..., None]


def local_exp_terms(s_local: torch.Tensor, rho_global, lam: float):
    """Shard-local numerators exp(−(Sₖ − ρ)/λ) and their partial η (summed
    over the last axis, kept) given the global ρ, which comes from a MIN
    all-reduce over the 'samples' axis; η is then a SUM of the partials."""
    e = torch.exp(-(s_local - rho_global) / lam)
    return e, torch.sum(e, dim=-1, keepdim=True)


def effective_sample_size(w: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / Σ wₖ²."""
    return 1.0 / ordered_sum(w * w)


def weight_entropy(w: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the weight distribution."""
    return -ordered_sum(
        torch.where(w > 0, w * torch.log(torch.clamp_min(w, 1e-38)), 0.0))
