"""Radial bases, cutoffs, distance transforms and edge geometry.

Counterpart of ``hydragnn_tpu/ops/rbf.py``: ``gaussian_smearing``,
``bessel_basis``, ``sinc_basis``, ``chebyshev_basis``, ``cosine_cutoff``,
``polynomial_cutoff``, ``envelope`` (the DimeNet envelope of PNAPlus's
Bessel basis), MACE's ``agnesi_transform`` and ``soft_transform``, and
``edge_vectors_and_lengths``.

An MLIP step differentiates these twice, and a padding edge (the
padding node to itself, no shift) has a zero displacement, so its length
is ``sqrt(eps)``. Every clamp is a ``torch.where`` or ``clamp`` whose
unselected branch stays finite, so no ``0 x inf`` reaches the forces.
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


def bessel_basis(dist: torch.Tensor, cutoff: float, num_radial: int) -> torch.Tensor:
    """sqrt(2/c) sin(n pi d / c) / d for n = 1..num_radial (spherical
    Bessel j0); d / c is clamped at 1e-8 inside."""
    freq = torch.arange(1, num_radial + 1, dtype=dist.dtype, device=dist.device) * math.pi
    d = dist[..., None] / cutoff
    d_safe = torch.where(d < 1e-8, 1e-8, d)
    return math.sqrt(2.0 / cutoff) * torch.sin(freq * d_safe) / (d_safe * cutoff)


def sinc_basis(dist: torch.Tensor, cutoff: float, num_basis: int) -> torch.Tensor:
    """sin(n pi d / c) / d for n = 1..num_basis, PaiNN's radial expansion.
    Lengths below 1e-8 are clamped there first (padding edges have length
    sqrt(eps), and sin(x)/x's gradient at 0 is 0/0)."""
    n = torch.arange(1, num_basis + 1, dtype=dist.dtype, device=dist.device)
    d_safe = torch.where(dist < 1e-8, 1e-8, dist)[..., None]
    return torch.sin(n * math.pi * d_safe / cutoff) / d_safe


def chebyshev_basis(dist: torch.Tensor, cutoff: float, num_basis: int) -> torch.Tensor:
    """cos(n arccos(x)) for n = 1..num_basis on x = 2 d / c - 1, clipped
    to [-1, 1]."""
    x = torch.clamp(2.0 * dist / cutoff - 1.0, -1.0, 1.0)[..., None]
    n = torch.arange(1, num_basis + 1, dtype=dist.dtype, device=dist.device)
    return torch.cos(n * torch.arccos(x))


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """0.5 (cos(pi d/c) + 1) for d < c else 0."""
    out = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, out, 0.0)


def polynomial_cutoff(dist: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """MACE's polynomial envelope on x = d / c, C^p smooth at the cutoff:
    1 - (p+1)(p+2)/2 x^p + p(p+2) x^(p+1) - p(p+1)/2 x^(p+2), zero from
    x = 1."""
    d = dist / cutoff
    pf = float(p)
    out = (
        1.0
        - (pf + 1.0) * (pf + 2.0) / 2.0 * d**p
        + pf * (pf + 2.0) * d ** (p + 1)
        - pf * (pf + 1.0) / 2.0 * d ** (p + 2)
    )
    return torch.where(d < 1.0, out, 0.0)


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


def agnesi_transform(
    dist: torch.Tensor,
    r_0: torch.Tensor,
    a: float = 1.0805,
    q: float = 0.9183,
    p: float = 4.5791,
) -> torch.Tensor:
    """Agnesi distance transform (1 + a x^q / (1 + x^(q-p)))^-1 on
    x = d / r_0 (clamped at 1e-12), decreasing from 1 to 0; ``r_0`` is the
    per-edge mean covalent radius of the endpoints."""
    x = torch.clamp(dist / r_0, min=1e-12)
    return 1.0 / (1.0 + a * x**q / (1.0 + x ** (q - p)))


def soft_transform(
    dist: torch.Tensor, r_0: torch.Tensor, a: float = 0.2, b: float = 3.0
) -> torch.Tensor:
    """Soft distance transform d + 0.5 tanh(-x - a x^b) + 0.5 on x = d /
    r_0, ``r_0`` the per-edge quarter-sum of the endpoint covalent
    radii."""
    x = dist / r_0
    return dist + 0.5 * torch.tanh(-x - a * x**b) + 0.5


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
