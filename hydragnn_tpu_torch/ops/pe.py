"""Positional encodings for global attention.

Counterpart of ``hydragnn_tpu/ops/pe.py``, copied: host-side numpy
Laplacian eigenvector PE and relative PE, computed once per sample
before training (an ``eigh`` per graph), so the port's samples carry the
same ``pe``/``rel_pe`` arrays as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def laplacian_pe(edge_index: np.ndarray, num_nodes: int, k: int) -> np.ndarray:
    """First k non-trivial eigenvectors of the normalized graph Laplacian.

    Returns [num_nodes, k] (zero-padded when the graph has fewer);
    sign-fixed by making the max-|.| entry of each vector positive.
    """
    A = np.zeros((num_nodes, num_nodes))
    if edge_index.size:
        A[edge_index[1], edge_index[0]] = 1.0
        A[edge_index[0], edge_index[1]] = 1.0
    deg = A.sum(axis=1)
    d_inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    L = np.eye(num_nodes) - d_inv_sqrt[:, None] * A * d_inv_sqrt[None, :]
    vals, vecs = np.linalg.eigh(L)
    order = np.argsort(vals)
    vecs = vecs[:, order]
    # Skip the trivial constant eigenvector (eigenvalue ~0).
    pe = vecs[:, 1 : k + 1]
    if pe.shape[1] < k:
        pe = np.pad(pe, ((0, 0), (0, k - pe.shape[1])))
    signs = np.sign(pe[np.argmax(np.abs(pe), axis=0), np.arange(pe.shape[1])])
    signs = np.where(signs == 0, 1.0, signs)
    return (pe * signs).astype(np.float32)


def relative_pe(edge_index: np.ndarray, pe: np.ndarray) -> np.ndarray:
    """Per-edge relative PE: pe[sender] - pe[receiver]."""
    if edge_index.size == 0:
        return np.zeros((0, pe.shape[1]), dtype=pe.dtype)
    return (pe[edge_index[0]] - pe[edge_index[1]]).astype(pe.dtype)
