"""E(3) algebra: real spherical harmonics and real Clebsch-Gordan tensors.

Counterpart of ``hydragnn_tpu/ops/e3.py``. The constants are built on
the host in float64 numpy by the same code, so every table equals the
JAX package's bit for bit:

- ``sh_coeff_matrix(l)``: the degree-l monomial coefficients of the real
  spherical harmonics (component normalization, ``||Y_l||^2 = 2l+1`` on
  a unit vector; m = -l..l, negative m the sin terms), fitted by least
  squares to the analytic harmonics at seeded random unit vectors;
- ``real_wigner_3j(l1, l2, l3)``: the real-basis coupling tensor, the
  Racah closed form moved to the real basis of those harmonics and
  checked for rotation invariance with Wigner D matrices fitted from the
  harmonics themselves (``wigner_d_from_sh``).

``sh_basis`` evaluates the harmonics in torch as ``monomials @
coefficients``. Each monomial is a product of repeated multiplications
(no ``pow``), so its first and second derivatives are finite at a zero
vector, where a padding edge sits.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "sh_dim",
    "sh_basis",
    "real_wigner_3j",
    "wigner_d_from_sh",
    "monomial_powers",
    "sh_coeff_matrix",
]


def sh_dim(lmax: int) -> int:
    """Total dimension of l = 0..lmax concatenated: (lmax+1)^2."""
    return (lmax + 1) ** 2


def _assoc_legendre(l: int, m: int, x: np.ndarray) -> np.ndarray:
    """P_l^m(x) without the Condon-Shortley phase."""
    pmm = np.ones_like(x)
    if m > 0:
        somx2 = np.sqrt(np.maximum(1.0 - x * x, 0.0))
        fact = 1.0
        for _ in range(m):
            pmm = pmm * fact * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2 * m + 1) * pmm
    if l == m + 1:
        return pmmp1
    pll = np.zeros_like(x)
    for ll in range(m + 2, l + 1):
        pll = ((2 * ll - 1) * x * pmmp1 - (ll + m - 1) * pmm) / (ll - m)
        pmm = pmmp1
        pmmp1 = pll
    return pll


def _real_sh_reference(l: int, vecs: np.ndarray) -> np.ndarray:
    """[K, 2l+1] analytic real harmonics at unit vectors, component
    normalization, m = -l..l (negative m: sin(|m| phi), positive m:
    cos(m phi))."""
    x, y, z = vecs[:, 0], vecs[:, 1], vecs[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    ct = np.clip(z / r, -1.0, 1.0)
    phi = np.arctan2(y, x)
    out = np.zeros((vecs.shape[0], 2 * l + 1))
    for m in range(0, l + 1):
        nrm = math.sqrt((2 * l + 1) * math.factorial(l - m) / math.factorial(l + m))
        plm = _assoc_legendre(l, m, ct)
        if m == 0:
            out[:, l] = nrm * plm
        else:
            out[:, l + m] = math.sqrt(2.0) * nrm * plm * np.cos(m * phi)
            out[:, l - m] = math.sqrt(2.0) * nrm * plm * np.sin(m * phi)
    return out


def monomial_powers(l: int) -> np.ndarray:
    """[(l+1)(l+2)/2, 3] exponent triples (a, b, c) with a+b+c = l."""
    return np.array(
        [(a, b, l - a - b) for a in range(l + 1) for b in range(l - a + 1)],
        dtype=np.int32,
    ).reshape(-1, 3)


def _monomials_np(vecs: np.ndarray, l: int) -> np.ndarray:
    """[K, n_monomials] degree-l monomials in ``monomial_powers`` order."""
    powers = monomial_powers(l)
    return np.prod(vecs[:, None, :] ** powers[None, :, :], axis=-1)


@lru_cache(maxsize=None)
def sh_coeff_matrix(l: int) -> np.ndarray:
    """[n_monomials, 2l+1] float64 coefficients: Y_l(v) = monomials(v) @
    C, fitted at seeded random unit vectors (exact: the harmonics are
    homogeneous degree-l polynomials on the sphere)."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(20240731 + l)
    k = max(4 * len(monomial_powers(l)), 64)
    v = rng.normal(size=(k, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    mono = _monomials_np(v, l)
    target = _real_sh_reference(l, v)
    coef, _, _, _ = np.linalg.lstsq(mono, target, rcond=None)
    err = np.abs(mono @ coef - target).max()
    if err > 1e-9:
        raise RuntimeError(f"SH l={l} polynomial fit failed: max err {err}")
    return coef


def sh_basis(
    vec: torch.Tensor,
    lmax: int,
    *,
    normalize: bool = True,
    coeffs: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Real spherical harmonics of l = 0..lmax, concatenated: vec [..., 3]
    -> [..., (lmax+1)^2]. With ``normalize`` the input is first divided
    by sqrt(|v|^2 + 1e-18), so a zero vector maps to zero. ``coeffs``
    gives ``sh_coeff_matrix(l)`` for l = 1..lmax as tensors already on
    the device (a module's buffers: a captured step may not copy from
    the host); without them the tables are copied in."""
    if normalize:
        vec = vec / torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-18)
    comps = (vec[..., 0], vec[..., 1], vec[..., 2])
    ones = torch.ones_like(comps[0])
    # pows[k][j] = comps[k] ** j by repeated multiplication
    pows = [[ones, c] for c in comps]
    for j in range(2, lmax + 1):
        for k in range(3):
            pows[k].append(pows[k][j - 1] * comps[k])
    outs = [ones[..., None]]
    for l in range(1, lmax + 1):
        coef = (
            torch.as_tensor(sh_coeff_matrix(l), device=vec.device)
            if coeffs is None else coeffs[l - 1]
        ).to(vec.dtype)
        mono = torch.stack(
            [pows[0][a] * pows[1][b] * pows[2][c] for a, b, c in monomial_powers(l)],
            dim=-1,
        )
        outs.append(mono @ coef)
    return torch.cat(outs, dim=-1)


def _f(n: int) -> float:
    return float(math.factorial(n))


def _complex_cg(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int) -> float:
    """Clebsch-Gordan <j1 m1 j2 m2 | j3 m3> (standard convention, Racah's
    closed form)."""
    if m1 + m2 != m3:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    pre = math.sqrt(
        (2 * j3 + 1)
        * _f(j3 + j1 - j2)
        * _f(j3 - j1 + j2)
        * _f(j1 + j2 - j3)
        / _f(j1 + j2 + j3 + 1)
    )
    pre *= math.sqrt(
        _f(j3 + m3) * _f(j3 - m3) * _f(j1 - m1) * _f(j1 + m1) * _f(j2 - m2) * _f(j2 + m2)
    )
    s = 0.0
    for k in range(0, j1 + j2 + j3 + 1):
        denoms = [
            j1 + j2 - j3 - k,
            j1 - m1 - k,
            j2 + m2 - k,
            j3 - j2 + m1 + k,
            j3 - j1 - m2 + k,
        ]
        if any(d < 0 for d in denoms) or k < 0:
            continue
        s += (-1.0) ** k / (_f(k) * np.prod([_f(d) for d in denoms]))
    return pre * s


@lru_cache(maxsize=None)
def _real_from_complex(l: int) -> np.ndarray:
    """A_l [2l+1, 2l+1] complex: Y_real = A_l @ Y_complex (the complex
    harmonics with the Condon-Shortley phase)."""
    A = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    A[l, l] = 1.0
    for m in range(1, l + 1):
        s = (-1.0) ** m
        A[l + m, l + m] = s / math.sqrt(2)
        A[l + m, l - m] = 1.0 / math.sqrt(2)
        A[l - m, l + m] = s / (1j * math.sqrt(2))
        A[l - m, l - m] = -1.0 / (1j * math.sqrt(2))
    return A


@lru_cache(maxsize=None)
def real_wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C [2l1+1, 2l2+1, 2l3+1] (float64),
    normalized to sum C^2 = 2l3+1; zero outside the triangle rule. Its
    rotation invariance is asserted when it is built."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    cg = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if -l3 <= m3 <= l3:
                cg[l1 + m1, l2 + m2, l3 + m3] = _complex_cg(l1, l2, l3, m1, m2, m3)
    A1 = _real_from_complex(l1)
    A2 = _real_from_complex(l2)
    A3 = _real_from_complex(l3)
    t = np.einsum("au,bv,cw,uvw->abc", A1, A2, np.conj(A3), cg)
    re, im = np.real(t), np.imag(t)
    t = re if np.abs(re).sum() >= np.abs(im).sum() else im
    nrm = np.sqrt((t**2).sum())
    if nrm < 1e-12:
        raise RuntimeError(f"real 3j ({l1},{l2},{l3}) vanished")
    t = t * math.sqrt(2 * l3 + 1) / nrm
    _assert_invariant(t, l1, l2, l3)
    return t


@lru_cache(maxsize=None)
def _rotation_samples() -> Tuple[np.ndarray, ...]:
    rng = np.random.default_rng(7)
    rots = []
    for _ in range(2):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        rots.append(q)
    return tuple(rots)


@lru_cache(maxsize=None)
def _wigner_d_np(l: int, rot_key: int) -> np.ndarray:
    return wigner_d_from_sh(l, _rotation_samples()[rot_key])


def _sh_basis_np(vecs: np.ndarray, l: int) -> np.ndarray:
    """[K, 2l+1] single-l harmonics in float64 numpy from the same
    ``sh_coeff_matrix`` constants."""
    vecs = np.asarray(vecs, dtype=np.float64)
    if l == 0:
        return np.ones((vecs.shape[0], 1))
    return _monomials_np(vecs, l) @ sh_coeff_matrix(l)


def wigner_d_from_sh(l: int, rot: np.ndarray) -> np.ndarray:
    """Wigner D matrix in this real basis, Y_l(R v) = D_l(R) Y_l(v),
    fitted by least squares in float64 from the harmonics themselves."""
    rot = np.asarray(rot, dtype=np.float64)
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(99 + l)
    v = rng.normal(size=(8 * (2 * l + 1), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    y = _sh_basis_np(v, l)
    yr = _sh_basis_np(v @ rot.T, l)
    d, _, _, _ = np.linalg.lstsq(y, yr, rcond=None)
    err = np.abs(y @ d - yr).max()
    if err > 1e-6:
        raise RuntimeError(f"Wigner D fit failed for l={l}: err {err}")
    return d.T


def _assert_invariant(t: np.ndarray, l1: int, l2: int, l3: int) -> None:
    for k in range(2):
        d1 = _wigner_d_np(l1, k)
        d2 = _wigner_d_np(l2, k)
        d3 = _wigner_d_np(l3, k)
        t2 = np.einsum("au,bv,cw,uvw->abc", d1, d2, d3, t)
        if np.abs(t2 - t).max() > 1e-5:
            raise RuntimeError(
                f"real 3j ({l1},{l2},{l3}) not invariant: {np.abs(t2 - t).max():.2e}"
            )
