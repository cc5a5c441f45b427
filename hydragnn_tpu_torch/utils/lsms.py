"""LSMS binary-alloy energy conversion.

Counterpart of ``hydragnn_tpu/utils/lsms.py``: convert per-configuration
total energies into formation enthalpies (total minus linear mixing of
pure-element energies) and formation Gibbs energies (enthalpy minus T
times the configurational entropy, ``k_B`` in Rydberg per kelvin),
rewriting LSMS text files into a sibling ``*_gibbs_energy`` directory,
each file written byte for byte as the JAX package writes it.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict, Sequence, Tuple

import numpy as np

# LSMS units: Rydberg. (reference :174-177)
_KB_RYDBERG_PER_KELVIN = 1.380649e-23 * 4.5874208973812e17


def _log_comb(n: int, k: int) -> float:
    """log(n choose k) via lgamma (scipy-free)."""
    return (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )


def _read_lsms(path: str) -> Tuple[float, list, np.ndarray]:
    with open(path) as f:
        lines = f.readlines()
    total_energy = float(lines[0].split()[0])
    atoms = np.loadtxt(lines[1:])
    if atoms.ndim == 1:
        atoms = atoms[None, :]
    return total_energy, lines, atoms


def compute_formation_enthalpy(
    elements_list: Sequence[float],
    pure_elements_energy: Dict[float, float],
    total_energy: float,
    atoms: np.ndarray,
) -> Tuple[float, float, float, float]:
    """(composition, linear mixing energy, formation enthalpy, entropy)
    for one binary-alloy configuration (reference :143-183)."""
    elements_list = sorted(elements_list)
    elements, counts = np.unique(atoms[:, 0], return_counts=True)
    for e in elements:
        if e not in elements_list:
            raise ValueError(
                f"configuration contains element {e} outside the binary "
                f"{elements_list}"
            )
    for i, elem in enumerate(elements_list):
        if elem not in elements:
            elements = np.insert(elements, i, elem)
            counts = np.insert(counts, i, 0)
    num_atoms = atoms.shape[0]
    composition = counts[0] / num_atoms
    linear_mixing_energy = (
        pure_elements_energy[elements[0]] * composition
        + pure_elements_energy[elements[1]] * (1 - composition)
    ) * num_atoms
    formation_enthalpy = total_energy - linear_mixing_energy
    entropy = _KB_RYDBERG_PER_KELVIN * _log_comb(num_atoms, int(counts[0]))
    return composition, linear_mixing_energy, formation_enthalpy, entropy


def convert_raw_data_energy_to_gibbs(
    dir: str,
    elements_list: Sequence[float],
    temperature_kelvin: float = 0.0,
    overwrite_data: bool = False,
) -> str:
    """Rewrite every LSMS file with its formation Gibbs energy in place
    of the total energy; returns the new directory (reference :30-140).
    Pure-element reference energies are taken from the single-element
    configurations that must be present in ``dir``.
    """
    dir = dir.rstrip("/")
    new_dir = dir + "_gibbs_energy/"
    if os.path.exists(new_dir) and os.listdir(new_dir):
        if not overwrite_data:
            raise FileExistsError(
                f"{new_dir} already contains converted data; pass "
                "overwrite_data=True to regenerate"
            )
        shutil.rmtree(new_dir)
    os.makedirs(new_dir, exist_ok=True)

    pure: Dict[float, float] = {}
    all_files = sorted(os.listdir(dir))
    for fname in all_files:
        total_energy, _, atoms = _read_lsms(os.path.join(dir, fname))
        uniq = np.unique(atoms[:, 0])
        if len(uniq) == 1:
            pure[float(uniq[0])] = total_energy / atoms.shape[0]
    if len(pure) != 2:
        raise ValueError(
            f"need pure-element configurations for both species; found "
            f"{sorted(pure)}"
        )

    for fname in all_files:
        path = os.path.join(dir, fname)
        total_energy, lines, atoms = _read_lsms(path)
        _, _, enthalpy, entropy = compute_formation_enthalpy(
            elements_list, pure, total_energy, atoms
        )
        gibbs = enthalpy - temperature_kelvin * entropy
        first = lines[0].split()
        first[0] = f"{gibbs}"
        lines[0] = " ".join(first) + "\n"
        with open(os.path.join(new_dir, fname), "w") as f:
            f.write("".join(lines))
    return new_dir
