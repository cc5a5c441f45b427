"""Element-count linear-regression energy baseline.

Counterpart of ``hydragnn_tpu/data/energy_regression.py`` (the
reference's hydragnn/preprocess/energy_linear_regression.py:19-199),
copied so the coefficients equal the JAX package's bit for bit: fit
per-element reference energies by least squares over element-count
vectors (SVD pseudo-inverse), subtract the baseline from every sample's
energy, and add it back to predictions.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample

NUM_ELEMENTS = 118


def solve_least_squares_svd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimum-norm least squares via SVD pseudo-inverse (reference
    energy_linear_regression.py:19-28); rank-deficient columns (absent
    elements) get zero coefficients."""
    u, s, vt = np.linalg.svd(a, full_matrices=False)
    tol = max(a.shape) * np.finfo(s.dtype).eps * (s[0] if len(s) else 1.0)
    s_inv = np.where(s > tol, 1.0 / np.where(s > tol, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


def element_counts(samples: Sequence[GraphSample]) -> np.ndarray:
    """[n_samples, 118] atoms-per-element matrix from x[:, 0] = Z."""
    out = np.zeros((len(samples), NUM_ELEMENTS))
    for i, s in enumerate(samples):
        z = np.clip(np.round(np.asarray(s.x)[:, 0]), 1, NUM_ELEMENTS)
        out[i] = np.bincount(
            z.astype(np.int64) - 1, minlength=NUM_ELEMENTS
        )
    return out


def fit_energy_baseline(
    samples: Sequence[GraphSample],
) -> np.ndarray:
    """[118] per-element baseline energies fitted to sample energies."""
    if not all(s.energy is not None for s in samples):
        raise ValueError("all samples need an energy to fit the baseline")
    a = element_counts(samples)
    b = np.array([float(s.energy) for s in samples])
    return solve_least_squares_svd(a, b)


def subtract_energy_baseline(
    samples: Sequence[GraphSample], coeff: np.ndarray
) -> List[GraphSample]:
    """New samples with energy := energy - counts @ coeff (the trainable
    residual); forces are untouched (the baseline is position-free)."""
    import dataclasses

    a = element_counts(samples)
    base = a @ np.asarray(coeff)
    return [
        dataclasses.replace(s, energy=float(s.energy) - float(base[i]))
        for i, s in enumerate(samples)
    ]


def apply_energy_baseline(
    samples: Sequence[GraphSample], energies: np.ndarray, coeff: np.ndarray
) -> np.ndarray:
    """Predicted residuals + baseline -> total energies."""
    a = element_counts(samples)
    return np.asarray(energies) + a @ np.asarray(coeff)
