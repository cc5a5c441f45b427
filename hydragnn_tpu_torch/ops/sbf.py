"""DimeNet's radial and spherical bases.

Counterpart of ``hydragnn_tpu/ops/sbf.py``: the host float64 helpers
``_jl_host``, ``spherical_bessel_roots`` and ``_radial_cheb_coeffs``,
copied, so the roots and the Chebyshev coefficients equal the JAX
package's bit for bit; then ``chebyshev_eval``, ``legendre_pl``,
``bessel_basis_envelope``, ``radial_bessel_jl`` and ``spherical_basis``
on tensors.

Each normalized radial function ``sqrt(2 / j_{l+1}(z_ln)^2) j_l(z_ln d)``
on d in [0, 1] is fitted once on the host by a float64 Chebyshev
interpolation and evaluated on the device as ``cos(k arccos t) @
coeffs``: one feature map and one matmul. The caller passes the
coefficients as a tensor (``DIMEStack`` keeps them as a non-persistent
float64 buffer), so a captured step never copies from the host; they are
cast to the distances' type at use, as the JAX package casts them.

Shapes: dist [E] -> rbf [E, num_radial]; (dist, angle, idx_kj) ->
sbf [T, num_spherical * num_radial].
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from hydragnn_tpu_torch.ops.rbf import envelope


def _jl_host(l: int, x: np.ndarray) -> np.ndarray:
    """Spherical Bessel j_l on the host in float64: scipy's
    ``spherical_jn`` where scipy is installed, else a series near zero
    and the upward recurrence elsewhere (~1e-9 absolute for l <= 8)."""
    x = np.asarray(x, dtype=np.float64)
    try:
        from scipy.special import spherical_jn

        return spherical_jn(l, x)
    except ImportError:
        pass
    x_safe = np.where(np.abs(x) < 1e-12, 1e-12, x)
    out_rec = np.sin(x_safe) / x_safe
    if l >= 1:
        jm, jc = out_rec, np.sin(x_safe) / x_safe**2 - np.cos(x_safe) / x_safe
        for n in range(1, l):
            jm, jc = jc, (2 * n + 1) / x_safe * jc - jm
        out_rec = jc
    t = 0.5 * x * x
    dfact = 1.0
    for k in range(l + 1):
        dfact *= 2 * k + 1
    ser = (
        x**l
        / dfact
        * (1.0 - t / (2 * l + 3) + t * t / (2.0 * (2 * l + 3) * (2 * l + 5)))
    )
    return np.where(np.abs(x) < 0.5, ser, out_rec)


@functools.lru_cache(maxsize=None)
def spherical_bessel_roots(num_spherical: int, num_radial: int) -> np.ndarray:
    """The first ``num_radial`` positive roots of j_l, l = 0 ..
    num_spherical - 1 [S, R]: j_0's are n pi; each later root is found
    by bisection inside the bracket of j_{l-1}'s roots it interlaces."""
    n_extra = num_radial + num_spherical
    roots = np.zeros((num_spherical, n_extra))
    roots[0] = np.arange(1, n_extra + 1) * np.pi
    for l in range(1, num_spherical):
        for k in range(n_extra - l):
            lo, hi = roots[l - 1, k], roots[l - 1, k + 1]
            flo = float(_jl_host(l, np.array([lo + 1e-9]))[0])
            for _ in range(80):
                mid = 0.5 * (lo + hi)
                fm = float(_jl_host(l, np.array([mid]))[0])
                if fm == 0.0:
                    lo = hi = mid
                    break
                if (fm > 0) == (flo > 0):
                    lo, flo = mid, fm
                else:
                    hi = mid
            roots[l, k] = 0.5 * (lo + hi)
    return roots[:, :num_radial].copy()


@functools.lru_cache(maxsize=None)
def _radial_cheb_coeffs(
    num_spherical: int, num_radial: int, degree: int = 64
) -> np.ndarray:
    """Chebyshev coefficients [degree, S*R] (float64) of the normalized
    radial functions on d in [0, 1], mapped to t = 2 d - 1."""
    z = spherical_bessel_roots(num_spherical, num_radial)
    norm = np.zeros_like(z)
    for l in range(num_spherical):
        norm[l] = np.sqrt(2.0 / _jl_host(l + 1, z[l]) ** 2)

    K = degree
    theta = (np.arange(K) + 0.5) * np.pi / K
    t_nodes = np.cos(theta)
    d_nodes = 0.5 * (t_nodes + 1.0)

    f = np.zeros((K, num_spherical, num_radial))
    for l in range(num_spherical):
        for n in range(num_radial):
            f[:, l, n] = norm[l, n] * _jl_host(l, z[l, n] * d_nodes)

    # DCT: c_k = (2 - delta_k0) / K sum_nodes f cos(k theta)
    kth = np.outer(np.arange(K), theta)
    weights = np.cos(kth)
    c = 2.0 / K * weights @ f.reshape(K, -1)
    c[0] *= 0.5
    return c


def chebyshev_eval(t: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """sum_k c_k T_k(t) for a coefficient matrix [K, F]: the feature map
    cos(k arccos t) [..., K] times ``coeffs``; t is clipped to [-1, 1]."""
    k = coeffs.shape[0]
    theta = torch.arccos(torch.clamp(t, -1.0, 1.0))
    ks = torch.arange(k, dtype=t.dtype, device=t.device)
    return torch.cos(theta[..., None] * ks) @ coeffs


def legendre_pl(c: torch.Tensor, l_max: int) -> torch.Tensor:
    """Legendre P_l(c) for l = 0 .. l_max [..., l_max + 1] by the upward
    recurrence."""
    p0 = torch.ones_like(c)
    outs = [p0]
    if l_max >= 1:
        outs.append(c)
        pm, pc = p0, c
        for l in range(1, l_max):
            pm, pc = pc, ((2 * l + 1) * c * pc - l * pm) / (l + 1)
            outs.append(pc)
    return torch.stack(outs, dim=-1)


def bessel_basis_envelope(
    dist: torch.Tensor, cutoff: float, num_radial: int, exponent: int = 5
) -> torch.Tensor:
    """DimeNet's radial basis u(d/c) sqrt(2/c) sin(n pi d/c) [E, R], with
    d/c clamped at 1e-8."""
    d = dist / cutoff
    d_safe = torch.where(d < 1e-8, 1e-8, d)
    freq = torch.arange(1, num_radial + 1, dtype=dist.dtype, device=dist.device) * math.pi
    env = envelope(d_safe, exponent)
    return env[..., None] * math.sqrt(2.0 / cutoff) * torch.sin(freq * d_safe[..., None])


def radial_bessel_jl(
    dist_scaled: torch.Tensor, coeffs: torch.Tensor, num_spherical: int, num_radial: int
) -> torch.Tensor:
    """The normalized j_l(z_ln d) for d in [0, 1] [..., S, R] from the
    Chebyshev table ``coeffs`` [K, S*R] (``_radial_cheb_coeffs``), cast
    to d's type."""
    flat = chebyshev_eval(2.0 * dist_scaled - 1.0, coeffs.to(dist_scaled.dtype))
    return flat.reshape(tuple(dist_scaled.shape) + (num_spherical, num_radial))


def spherical_basis(
    dist: torch.Tensor,
    angle: torch.Tensor,
    idx_kj: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    cutoff: float,
    num_spherical: int,
    num_radial: int,
    envelope_exponent: int = 5,
) -> torch.Tensor:
    """DimeNet's 2-D spherical basis a_SBF(d_kj, angle) [T, S*R]:
    ``dist`` per edge [E], ``angle`` per triplet [T], ``idx_kj`` each
    triplet's k->j edge, ``coeffs`` the Chebyshev table."""
    d = torch.clamp(dist / cutoff, 0.0, 1.0)
    radial = radial_bessel_jl(d, coeffs, num_spherical, num_radial)
    env = envelope(torch.where(d < 1e-8, 1e-8, d), envelope_exponent)
    radial = radial * env[:, None, None]
    # Y_l^0(angle) = sqrt((2l + 1) / 4 pi) P_l(cos angle)
    ls = torch.arange(num_spherical, dtype=dist.dtype, device=dist.device)
    cbf = legendre_pl(torch.cos(angle), num_spherical - 1) * torch.sqrt(
        (2.0 * ls + 1.0) / (4.0 * math.pi)
    )
    out = radial.index_select(0, idx_kj) * cbf[:, :, None]
    return out.reshape(out.shape[0], num_spherical * num_radial)
