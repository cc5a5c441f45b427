"""Radial basis, cutoff and edge geometry for the SchNet, PaiNN and
PNAPlus paths.

Counterpart of ``hydragnn_tpu/ops/rbf.py``: ``gaussian_smearing``,
``sinc_basis``, ``cosine_cutoff``, ``envelope`` (the DimeNet envelope of
PNAPlus's Bessel basis) and ``edge_vectors_and_lengths``. The other
bases (Chebyshev, polynomial cutoff, distance transforms) come with the
stacks that use them (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def gaussian_smearing(
    dist: torch.Tensor, start: float, stop: float, num_gaussians: int
) -> torch.Tensor:
    """exp(-gamma (d - mu_k)^2) on an even grid of centers."""
    offset = torch.linspace(
        start, stop, num_gaussians, dtype=dist.dtype, device=dist.device
    )
    coeff = -0.5 / (offset[1] - offset[0]) ** 2
    diff = dist[..., None] - offset
    return torch.exp(coeff * diff**2)


def sinc_basis(dist: torch.Tensor, cutoff: float, num_basis: int) -> torch.Tensor:
    """sin(n pi d / c) / d for n = 1..num_basis, PaiNN's radial expansion.
    Lengths below 1e-8 are clamped there first (padding edges have length
    sqrt(eps), and sin(x)/x's gradient at 0 is 0/0)."""
    n = torch.arange(1, num_basis + 1, dtype=dist.dtype, device=dist.device)
    d_safe = torch.where(dist < 1e-8, 1e-8, dist)[..., None]
    return torch.sin(n * math.pi * d_safe / cutoff) / d_safe


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """0.5 (cos(pi d/c) + 1) for d < c else 0."""
    out = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, out, 0.0)


def envelope(dist_scaled: torch.Tensor, exponent: int = 5) -> torch.Tensor:
    """DimeNet's smooth envelope u(x) with u(1) = u'(1) = u''(1) = 0 on
    x = d / cutoff, zero from x = 1; x is clamped at 1e-8 inside 1/x."""
    p = exponent + 1
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2.0)
    c = -p * (p + 1) / 2.0
    x = dist_scaled
    x_safe = torch.where(x < 1e-8, 1e-8, x)
    out = 1.0 / x_safe + a * x ** (p - 1) + b * x**p + c * x ** (p + 1)
    return torch.where(x < 1.0, out, 0.0)


def edge_vectors_and_lengths(
    pos: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    shifts: Optional[torch.Tensor] = None,
    *,
    normalize: bool = False,
    eps: float = 1e-9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """vec = pos[s] - pos[r] (+ shift); length = sqrt(|vec|^2 + eps).
    Returns (vectors [E, 3], lengths [E])."""
    vec = pos[senders] - pos[receivers]
    if shifts is not None:
        vec = vec + shifts
    length = torch.sqrt(torch.sum(vec * vec, dim=-1) + eps)
    if normalize:
        vec = vec / length[..., None]
    return vec, length
