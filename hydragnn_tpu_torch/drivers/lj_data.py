"""Lennard-Jones dataset generation.

Counterpart of ``examples/LennardJones/LJ_data.py``: simple-cubic
lattices with random vacancies and thermal displacement, energies and
analytic forces from a truncated 6-12 Lennard-Jones potential under
periodic boundary conditions, on the port's ``radius_graph_pbc``. The
draws are numpy's, in the reference's order, so a seed gives the
reference's samples bit for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample
from hydragnn_tpu_torch.ops.neighbors import radius_graph_pbc

LATTICE_CONSTANT = 3.8  # Angstrom
EPSILON = 1.0
SIGMA = 2.5


def lj_energy_forces(
    pos: np.ndarray,
    cell: np.ndarray,
    cutoff: float,
    neighbors: Tuple[np.ndarray, np.ndarray] = None,
) -> Tuple[float, np.ndarray]:
    """Total LJ energy and per-atom forces with PBC (pair-summed).
    ``neighbors`` reuses a precomputed (edge_index, shifts) pair."""
    ei, shifts = neighbors or radius_graph_pbc(pos, cell, cutoff)
    snd, rcv = ei
    vec = pos[snd] + shifts - pos[rcv]  # displacement r_s - r_r (+shift)
    d = np.linalg.norm(vec, axis=1)
    d = np.maximum(d, 1e-6)
    sr6 = (SIGMA / d) ** 6
    sr12 = sr6 * sr6
    # pair energy counted twice in the directed edge list -> halve
    energy = float(np.sum(4.0 * EPSILON * (sr12 - sr6)) / 2.0)
    # dE/dd per directed edge; force on receiver along -vec/d
    dEdd = 4.0 * EPSILON * (-12.0 * sr12 + 6.0 * sr6) / d
    f_pair = -dEdd[:, None] * (vec / d[:, None])
    forces = np.zeros_like(pos)
    np.add.at(forces, rcv, -f_pair)
    return energy, forces


def configuration(
    ucells: Tuple[int, int, int],
    rng: np.random.Generator,
    *,
    vacancy_rate: float = 0.05,
    jitter: float = 0.05,
    cutoff: float = 5.0,
) -> GraphSample:
    nx, ny, nz = ucells
    a = LATTICE_CONSTANT
    grid = np.array(
        [(x, y, z) for x in range(nx) for y in range(ny) for z in range(nz)],
        dtype=np.float64,
    )
    pos = grid * a + rng.normal(scale=jitter * a, size=grid.shape)
    keep = rng.uniform(size=len(pos)) > vacancy_rate
    if keep.sum() < 2:
        keep[:2] = True
    pos = pos[keep]
    cell = np.diag([nx * a, ny * a, nz * a])
    ei, shifts = radius_graph_pbc(pos, cell, cutoff)
    energy, forces = lj_energy_forces(pos, cell, cutoff, neighbors=(ei, shifts))
    return GraphSample(
        x=np.ones((len(pos), 1), np.float32),  # single species
        pos=pos.astype(np.float32),
        edge_index=ei,
        edge_shifts=shifts.astype(np.float32),
        cell=cell.astype(np.float32),
        energy=energy,
        forces=forces.astype(np.float32),
        y_graph=np.array([energy], np.float32),
    )


def create_dataset(
    number_configurations: int = 300,
    *,
    cutoff: float = 5.0,
    seed: int = 0,
) -> List[GraphSample]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(number_configurations):
        ucells = tuple(int(v) for v in rng.integers(2, 4, 3))
        out.append(configuration(ucells, rng, cutoff=cutoff))
    return out
