"""Symmetric tensor contraction: MACE's n-body product basis.

Counterpart of ``hydragnn_tpu/ops/symmetric_contraction.py``.
``u_matrix_real(lmax_in, l_out, nu)`` is the orthonormal basis of
permutation-symmetric equivariant maps Sym^nu(V) -> irrep ``l_out``
(V the concatenated harmonics space, dim M = (lmax_in+1)^2): chains of
real Clebsch-Gordan tensors (``_coupling_maps``), symmetrized over the
factor permutations and orthonormalized by an SVD, all in float64 numpy
by the JAX package's code, so the tables equal its own bit for bit.

``SymmetricContraction`` contracts node features [N, C, M] with the
per-element weights ``w{l_out}_{i}`` [num_elements, P, C] of each output
irrep and correlation order, in MACE's descending chain (the highest
order first, each lower order added before one more contraction with
x). The einsums are the JAX package's (factor letters ``_ABC``), written
as pairwise contractions: the weights meet the one-hot first (a matmul
that picks each node's row), so no intermediate holds the element axis
or grows past [N, C, 2l+1, M^nu].
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
from torch import nn

from hydragnn_tpu_torch.ops.e3 import real_wigner_3j, sh_dim


def _block(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


@lru_cache(maxsize=None)
def _coupling_maps(
    lmax_in: int, nu: int, lam_cap: int
) -> Tuple[Tuple[int, np.ndarray], ...]:
    """All CG-chain tensors coupling nu factors of V to an irrep lam:
    tuples (lam, T) with T [2 lam + 1, M, ..., M] (nu M-axes);
    intermediates above ``lam_cap`` are pruned."""
    M = sh_dim(lmax_in)
    if nu == 1:
        out = []
        for l in range(lmax_in + 1):
            t = np.zeros((2 * l + 1, M))
            t[:, _block(l)] = np.eye(2 * l + 1)
            out.append((l, t))
        return tuple(out)
    prev = _coupling_maps(lmax_in, nu - 1, lam_cap + lmax_in)
    out = []
    for lam_prev, tp in prev:
        for l in range(lmax_in + 1):
            for lam in range(abs(lam_prev - l), lam_prev + l + 1):
                if lam > lam_cap:
                    continue
                cg = real_wigner_3j(lam_prev, l, lam)
                t = np.einsum("abc,a...->cb...", cg, tp)
                full = np.zeros(t.shape[:1] + (M,) + t.shape[2:])
                full[:, _block(l)] = t
                out.append((lam, np.moveaxis(full, 1, -1)))
    return tuple(out)


@lru_cache(maxsize=None)
def u_matrix_real(lmax_in: int, l_out: int, nu: int) -> np.ndarray:
    """Orthonormal symmetric coupling basis [2 l_out + 1, M^nu..., P]
    (float64); P may be 0 when no coupling reaches ``l_out``."""
    M = sh_dim(lmax_in)
    cands = [t for lam, t in _coupling_maps(lmax_in, nu, l_out) if lam == l_out]
    if not cands:
        return np.zeros((2 * l_out + 1,) + (M,) * nu + (0,))
    perms = list(itertools.permutations(range(nu)))
    sym = []
    for t in cands:
        acc = np.zeros_like(t)
        for p in perms:
            acc = acc + np.transpose(t, (0,) + tuple(1 + np.argsort(p)))
        acc /= len(perms)
        if np.abs(acc).max() > 1e-10:
            sym.append(acc)
    if not sym:
        return np.zeros((2 * l_out + 1,) + (M,) * nu + (0,))
    flat = np.stack([t.reshape(-1) for t in sym])
    _, s, vh = np.linalg.svd(flat, full_matrices=False)
    basis = vh[s > 1e-8 * s[0]]
    out = basis.reshape((basis.shape[0], 2 * l_out + 1) + (M,) * nu)
    return np.moveaxis(out, 0, -1)


# Factor-axis einsum letters, as in the JAX package: not b (batch), c
# (channels), e (elements), i (contracted factor), k (params), z (m).
_ABC = "dfghjl"


class SymmetricContraction(nn.Module):
    """x [N, C, M], node one-hot y [N, Z] -> [N, C, sum_l (2l+1)] over
    l_out = 0..lmax_out. Parameters ``w{l_out}_{i}`` [Z, P, C] for each
    correlation order i (the highest always; a lower one where its basis
    is not empty), drawn as normal / P in the JAX package. The U tables
    are non-persistent float64 buffers ``u{l_out}_{i}`` (the model's
    ``.to(dtype)`` casts them once, as the JAX package casts each use),
    so they move with the module and a captured step reads them from the
    card."""

    def __init__(self, lmax_in: int, lmax_out: int, correlation: int,
                 num_elements: int, channels: int):
        super().__init__()
        self.lmax_out, self.correlation = lmax_out, correlation
        for l_out in range(lmax_out + 1):
            for i in range(1, correlation + 1):
                u = u_matrix_real(lmax_in, l_out, i)
                p = u.shape[-1]
                self.register_buffer(
                    f"u{l_out}_{i}",
                    torch.as_tensor(u.squeeze(0) if l_out == 0 else u),
                    persistent=False,
                )
                if i == correlation or p:
                    setattr(self, f"w{l_out}_{i}", nn.Parameter(
                        torch.empty(num_elements, p, channels)))

    def flax_init(self, name: str, p: torch.Tensor, gen: torch.Generator) -> None:
        """jax.random.normal(shape) / max(P, 1)."""
        p.copy_(torch.randn(p.shape, generator=gen) / max(p.shape[1], 1))

    def _u(self, l_out: int, i: int, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"u{l_out}_{i}").to(x.dtype)

    def _wy(self, l_out: int, i: int, y: torch.Tensor) -> torch.Tensor:
        """[N, P, C]: each node's element row of ``w{l_out}_{i}``."""
        w = getattr(self, f"w{l_out}_{i}")
        z, p, c = w.shape
        return (y @ w.reshape(z, p * c).to(y.dtype)).reshape(-1, p, c)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        outs = [self._contract_irrep(x, y, l_out) for l_out in range(self.lmax_out + 1)]
        return torch.cat(outs, dim=-1)

    def _contract_irrep(self, x, y, l_out: int) -> torch.Tensor:
        nu = self.correlation
        mo = "z" if l_out > 0 else ""
        ii = _ABC[: nu - 1]
        # out[b,c,(z),ii] = U[(z),ii,i,k] W[e,k,c] y[b,e] x[b,c,i]
        t = torch.einsum(f"{mo}{ii}ik,bkc->bc{mo}{ii}i", self._u(l_out, nu, x),
                         self._wy(l_out, nu, y))
        out = torch.einsum(f"bc{mo}{ii}i,bci->bc{mo}{ii}", t, x)
        for i in range(nu - 1, 0, -1):
            if getattr(self, f"u{l_out}_{i}").shape[-1] == 0:
                c_tensor = out
            else:
                jj = _ABC[:i]
                c_tensor = torch.einsum(f"{mo}{jj}k,bkc->bc{mo}{jj}",
                                        self._u(l_out, i, x), self._wy(l_out, i, y)) + out
            kk = _ABC[: i - 1]
            out = torch.einsum(f"bc{mo}{kk}i,bci->bc{mo}{kk}", c_tensor, x)
        return out[..., None] if l_out == 0 else out
