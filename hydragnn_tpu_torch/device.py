"""Device resolution shared by the port's entry points.

No JAX counterpart: the JAX package lets the backend choose. The port's
entry points (``create_model``, ``ServingEngine``) run on the card unless
the caller names another device, and never fall back to the CPU on
their own. Under several ranks on a node, ``None`` is the rank's own
card, ``cuda:LOCAL_RANK`` (``parallel/runtime.local_rank``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means ``"cuda:<LOCAL_RANK>"`` (``cuda:0`` without a
    launcher). A CUDA device without a visible card raises instead of
    quietly running on the CPU."""
    if device is None:
        from hydragnn_tpu_torch.parallel.runtime import local_rank

        device = f"cuda:{local_rank()}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run the plain CPU path"
        )
    return dev
