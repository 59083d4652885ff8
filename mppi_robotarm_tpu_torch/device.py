"""Where the port's entry points put their tensors.

The JAX package runs on its default backend, the accelerator; the port's
counterpart is the CUDA device.  The entry points that make state
(``init_state``, ``init_sim``, ``init_sim_batch``, the ``convert`` and
checkpoint loaders) take ``device=None`` to mean ``cuda`` and run on the
CPU only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for, by default or by name,
    and there is no CUDA device: nothing falls back to the CPU silently.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {device}: the port's entry points run on "
            f"the GPU by default; pass device=\"cpu\" to run on the CPU")
    return device
