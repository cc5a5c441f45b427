"""Synthetic periodic crystals for the crystal drivers.

Counterpart of ``examples/common/crystals.py``: multi-species
simple-cubic crystals with thermal displacement and vacancies, energies
and analytic forces from a species-pair Lennard-Jones potential under
periodic boundary conditions, on the port's ``radius_graph_pbc``. The
draws are numpy's, in the reference's order, so a seed gives the
reference's samples bit for bit. The mptrj, alexandria, eam and omat24
drivers (and ``chip_smoke.py``) build their data here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample
from hydragnn_tpu_torch.ops.neighbors import radius_graph_pbc

# Per-species LJ parameters (epsilon, sigma); pairs combine by
# Lorentz-Berthelot rules, so mixed compositions have distinct PES.
LJ_SPECIES = {
    28: (1.00, 2.2),  # Ni
    41: (1.35, 2.6),  # Nb
    13: (0.80, 2.5),  # Al
    22: (1.10, 2.4),  # Ti
}


def lj_multispecies_energy_forces(
    pos: np.ndarray, z: np.ndarray, cell: np.ndarray, cutoff: float,
) -> Tuple[float, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Species-pair LJ under PBC. Returns (energy, forces, per-atom
    energies, edge_index, shifts); the neighbor list is reused for the
    sample's graph."""
    ei, shifts = radius_graph_pbc(pos, cell, cutoff)
    snd, rcv = ei
    eps_s = np.array([LJ_SPECIES[int(s)][0] for s in z])
    sig_s = np.array([LJ_SPECIES[int(s)][1] for s in z])
    eps = np.sqrt(eps_s[snd] * eps_s[rcv])
    sig = 0.5 * (sig_s[snd] + sig_s[rcv])
    vec = pos[snd] + shifts - pos[rcv]
    d = np.maximum(np.linalg.norm(vec, axis=1), 1e-6)
    sr6 = (sig / d) ** 6
    sr12 = sr6 * sr6
    e_edge = 4.0 * eps * (sr12 - sr6)
    energy = float(e_edge.sum() / 2.0)
    # half of each directed pair energy lands on the receiver
    e_atom = np.zeros(len(pos))
    np.add.at(e_atom, rcv, e_edge / 2.0)
    dEdd = 4.0 * eps * (-12.0 * sr12 + 6.0 * sr6) / d
    f_pair = -dEdd[:, None] * (vec / d[:, None])
    forces = np.zeros_like(pos)
    np.add.at(forces, rcv, -f_pair)
    return energy, forces, e_atom, ei, shifts


def random_crystals(
    n_structures: int,
    *,
    species: Sequence[int] = (28, 41),
    lattice_constant: float = 3.2,
    cells_range: Tuple[int, int] = (2, 4),
    cutoff: float = 5.0,
    jitter: float = 0.06,
    vacancy_rate: float = 0.04,
    per_atom_energy: bool = False,
    node_energies: bool = False,
    normalize: bool = True,
    seed: int = 0,
) -> List[GraphSample]:
    """Thermally displaced multi-species crystals (the MPTrj/Alexandria
    shape). Node features = [Z]; ``y_graph`` = total energy, or energy
    per atom when ``per_atom_energy``; ``node_energies`` also writes
    per-atom energies to ``y_node`` (the EAM multitask target)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_structures):
        nx, ny, nz = (int(v) for v in rng.integers(*cells_range, 3))
        a = lattice_constant
        grid = np.stack(np.meshgrid(np.arange(nx) * a, np.arange(ny) * a, np.arange(nz) * a,
                                    indexing="ij"), axis=-1).reshape(-1, 3)
        keep = rng.uniform(size=len(grid)) > vacancy_rate
        if keep.sum() < 2:
            keep[:2] = True
        z = rng.choice(species, keep.sum()).astype(np.int64)
        cell = np.diag([nx * a, ny * a, nz * a]).astype(np.float64)
        # rejection-sample the thermal displacement: a jitter tail that
        # walks a pair into the r^-12 core gives an unusable outlier
        for _attempt in range(50):
            disp = rng.normal(scale=jitter * a, size=(keep.sum(), 3))
            pos = grid[keep] + disp
            energy, forces, e_atom, ei, shifts = lj_multispecies_energy_forces(
                pos, z, cell, cutoff)
            if e_atom.max() < 2.0 and np.abs(forces).max() < 30.0:
                break
        target = energy / len(pos) if per_atom_energy else energy
        out.append(GraphSample(
            x=z.reshape(-1, 1).astype(np.float32),
            pos=pos.astype(np.float32),
            edge_index=ei,
            edge_shifts=shifts.astype(np.float32),
            cell=cell.astype(np.float32),
            energy=energy,
            forces=forces.astype(np.float32),
            y_graph=np.array([target], np.float32),
            y_node=e_atom.reshape(-1, 1).astype(np.float32) if node_energies else None,
        ))
    if normalize:
        out = _normalize_crystal_energies(out, per_atom_energy=per_atom_energy)
    return out


def _normalize_crystal_energies(
    samples: List[GraphSample], *, per_atom_energy: bool
) -> List[GraphSample]:
    """Center and scale energies across the set, keeping F = -dE/dx and
    sum(per-atom) = total: E' = (E - mu)/s, F' = F/s,
    e_atom' = (e_atom - mu/n)/s."""
    e = np.array([s.energy for s in samples])
    mu, s_ = float(e.mean()), float(max(e.std(), 1e-6))
    out = []
    for s in samples:
        n = s.num_nodes
        energy = (s.energy - mu) / s_
        target = energy / n if per_atom_energy else energy
        out.append(dataclasses.replace(
            s,
            energy=energy,
            forces=(s.forces / s_).astype(np.float32),
            y_graph=np.array([target], np.float32),
            y_node=(((s.y_node - mu / n) / s_).astype(np.float32)
                    if s.y_node is not None else None),
        ))
    return out
