"""Windowed nearest-waypoint search (reference control.py:200-232).

The reference scans the window ``ref_path[prev_idx : prev_idx+W]`` from the
frozen index (quirk Q5) and breaks ties towards the first index.  At the
path end the slice truncates: here the window is a clamped gather with a
validity mask, so its shape never changes.  ``update_waypoint_index``
also advances B scenarios at once, where the JAX package vmaps it
(``mppi/solver.py:215-222``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def slice_window(ref_path: torch.Tensor, start_idx, window_len: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather ``ref_path[start_idx : start_idx+window_len]`` with a mask.

    ``start_idx`` is one index or a (B,) tensor of them.  Returns (window
    (..., W, C), valid (..., W) bool).  Rows past the path end are clamped
    to the last row and masked invalid.
    """
    n = ref_path.shape[0]
    start = torch.as_tensor(start_idx, device=ref_path.device)
    idx = start[..., None] + torch.arange(window_len, device=ref_path.device)
    valid = idx < n
    window = ref_path[torch.clamp(idx, max=n - 1)]
    return window, valid


def nearest_in_window(x: torch.Tensor, y: torch.Tensor, window: torch.Tensor,
                      valid: torch.Tensor, dist_scale: float):
    """Masked nearest-waypoint lookup against a pre-sliced window.

    ``window`` (W, C) with ``valid`` (W,) against positions of any shape,
    or (B, W, C) with (B, W) against (B,) positions, one window each.
    Returns (offset within the window, ref_x, ref_y, ref_dq1, ref_dq2).  The
    metric is ``(dx² + dy²)·dist_scale`` (control.py:212); ties resolve to
    the lowest offset, as ``list.index(min(d))`` does (control.py:215) and
    as ``torch.argmin`` does.
    """
    dx = x[..., None] - window[..., 0]
    dy = y[..., None] - window[..., 1]
    d = (dx * dx + dy * dy) * dist_scale
    d = torch.where(valid, d, torch.inf)
    off = torch.argmin(d, dim=-1)
    if window.dim() == 2:
        ref = window[off]
    else:                       # (B, W, C): one window per scenario
        ref = torch.take_along_dim(window, off[..., None, None],
                                   dim=-2)[..., 0, :]
    return off, ref[..., 0], ref[..., 1], ref[..., 2], ref[..., 3]


def update_waypoint_index(ref_path: torch.Tensor, wp_idx, x, y,
                          window_len: int, dist_scale: float):
    """Once-per-solve frozen-index advance (control.py:75) of one scenario,
    or of B at once (``wp_idx``, ``x``, ``y`` (B,)) with the same
    elementwise arithmetic, so each gets the bits of its own update.

    Returns (new_idx, window (..., W, 4), valid (..., W)), the window
    re-sliced at the new index for all K×T stage-cost lookups (Q5).  The
    path-end condition ``new_idx >= len(ref_path) - 1`` is left to the
    caller.
    """
    window0, valid0 = slice_window(ref_path, wp_idx, window_len)
    off, *_ = nearest_in_window(x, y, window0, valid0, dist_scale)
    new_idx = wp_idx + off
    window, valid = slice_window(ref_path, new_idx, window_len)
    return new_idx, window, valid
