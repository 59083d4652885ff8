"""Control-sequence median filter (reference control.py:122, quirk Q10).

``scipy.ndimage.median_filter(size=s, mode='reflect')`` per control
dimension over the horizon axis, reproduced bit for bit for ``s <= 2T``:
the window of output i spans offsets ``[-(s//2), s - s//2 - 1]``, 'reflect'
repeats the edge sample (NumPy's 'symmetric'), and an even window takes the
upper middle order statistic (rank s//2), without averaging.
"""

from __future__ import annotations

import torch


def median_filter_reflect(x: torch.Tensor, size: int) -> torch.Tensor:
    """Moving median over axis 0 of ``x`` (shape (T, D)), scipy-exact."""
    if size < 1:
        raise ValueError("size must be >= 1")
    if size == 1:
        return x
    t = x.shape[0]
    left = size // 2
    # edge-inclusive reflection with period 2t: ... b a | a b c d | d c ...
    # The indices are made on x's device, so a CUDA graph can capture the
    # filter: a copy from the host would stop the capture.
    idx = torch.arange(-left, t - left + size - 1, device=x.device)
    period = 2 * t
    j = torch.remainder(idx, period)
    j = torch.where(j < t, j, period - 1 - j)
    xp = x[j]
    windows = torch.stack([xp[k:k + t] for k in range(size)], dim=0)
    return torch.sort(windows, dim=0).values[size // 2]
