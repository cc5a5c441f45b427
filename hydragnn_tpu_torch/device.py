"""Device resolution shared by the port's entry points.

No JAX counterpart: the JAX package lets the backend choose. The port's
entry points (``create_model``, ``ServingEngine``) run on the card unless
the caller names another device, and never fall back to the CPU on
their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a visible card
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass device='cpu' to run the plain CPU path"
        )
    return dev
