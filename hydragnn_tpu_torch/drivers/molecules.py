"""Synthetic molecules for the molecule drivers.

Counterpart of ``examples/common/molecules.py``: molecules whose
energies and analytic forces come from a species-dependent pairwise
Morse potential, as thermal frames of a pool of random molecules
(``random_molecule_frames``: the ANI-1x / QM7-X shape) or as frames
along reactant -> product paths (``reaction_path_frames``: the
Transition1x shape), on the port's ``radius_graph``. The draws are
numpy's, in the reference's order, so a seed gives the reference's
samples bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample
from hydragnn_tpu_torch.ops.neighbors import radius_graph

# Per-element Morse well depth / width / equilibrium radius. Pair
# parameters combine by geometric (depth) and arithmetic (width, r0)
# means, so composition changes the potential-energy surface.
MORSE_PARAMS = {
    1: (0.25, 1.6, 1.1),  # H
    6: (0.60, 1.2, 1.7),  # C
    7: (0.55, 1.3, 1.6),  # N
    8: (0.50, 1.4, 1.5),  # O
    16: (0.45, 1.1, 2.0),  # S
}


def morse_energy_forces(pos: np.ndarray, z: np.ndarray) -> Tuple[float, np.ndarray]:
    """Species-dependent pairwise Morse energy and per-atom forces."""
    params = np.array([MORSE_PARAMS[int(s)] for s in z], dtype=np.float64)  # [n, 3]
    d_i, a_i, r_i = params.T
    D = np.sqrt(d_i[:, None] * d_i[None, :])
    A = 0.5 * (a_i[:, None] + a_i[None, :])
    R0 = 0.5 * (r_i[:, None] + r_i[None, :])

    diff = pos[:, None, :] - pos[None, :, :]  # [n, n, 3]
    d = np.linalg.norm(diff, axis=-1)
    np.fill_diagonal(d, np.inf)
    ex = np.exp(-A * (d - R0))
    energy = float((D * (1.0 - ex) ** 2).sum() / 2.0)
    dedr = 2.0 * D * A * (1.0 - ex) * ex
    with np.errstate(invalid="ignore"):
        unit = np.where(np.isfinite(d[..., None]), diff / d[..., None], 0.0)
    forces = -(dedr[..., None] * unit).sum(axis=1)
    return energy, forces.astype(np.float32)


def _normalize_energies(samples: List[GraphSample]) -> List[GraphSample]:
    """Center and scale energies across the set; forces are scaled by
    the same factor so F = -dE/dx keeps holding."""
    e = np.array([s.energy for s in samples])
    mu, scale = float(e.mean()), float(max(e.std(), 1e-6))
    out = []
    for s in samples:
        energy = (s.energy - mu) / scale
        out.append(dataclasses.replace(s, energy=energy,
                                       forces=(s.forces / scale).astype(np.float32),
                                       y_graph=np.array([energy], np.float32)))
    return out


def _packed_positions(n: int, rng: np.random.Generator, *, min_dist: float = 1.0,
                      box_scale: float = 1.9) -> np.ndarray:
    """Random positions with a minimum pairwise distance (rejection
    sampling), so no frame starts inside the repulsive core."""
    box = box_scale * n ** (1 / 3) + 1.0
    pts = [rng.uniform(0, box, 3)]
    attempts = 0
    while len(pts) < n:
        cand = rng.uniform(0, box, 3)
        if min(np.linalg.norm(cand - p) for p in pts) >= min_dist:
            pts.append(cand)
        attempts += 1
        if attempts > 200 * n:  # loosen if the box is too tight
            box *= 1.1
            attempts = 0
    return np.asarray(pts)


def random_molecule_frames(
    n_frames: int,
    *,
    species: Sequence[int] = (1, 6, 7, 8),
    n_atoms_range: Tuple[int, int] = (6, 16),
    n_molecules: int = 12,
    cutoff: float = 4.0,
    max_neighbours: int = 24,
    jitter: float = 0.10,
    seed: int = 0,
    feature: str = "z",
) -> List[GraphSample]:
    """Thermal frames of a pool of random molecules (many small
    molecules x many conformations). ``feature`` selects node features:
    ``"z"`` (atomic number column) or ``"onehot"`` (one-hot over
    ``species``, then Z)."""
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_molecules):
        n = int(rng.integers(*n_atoms_range))
        z = rng.choice(species, n).astype(np.int64)
        mols.append((z, _packed_positions(n, rng)))

    out = []
    for i in range(n_frames):
        z, base = mols[i % len(mols)]
        pos = (base + rng.normal(scale=jitter, size=base.shape)).astype(np.float32)
        energy, forces = morse_energy_forces(pos, z)
        if feature == "onehot":
            x = np.zeros((len(z), len(species) + 1), np.float32)
            for j, s in enumerate(species):
                x[z == s, j] = 1.0
            x[:, -1] = z
        else:
            x = z.reshape(-1, 1).astype(np.float32)
        out.append(GraphSample(x=x, pos=pos,
                               edge_index=radius_graph(pos, cutoff,
                                                       max_neighbours=max_neighbours),
                               energy=energy, forces=forces,
                               y_graph=np.array([energy], np.float32)))
    return _normalize_energies(out)


def reaction_path_frames(
    n_reactions: int,
    frames_per_path: int = 10,
    *,
    species: Sequence[int] = (1, 6, 7, 8),
    n_atoms_range: Tuple[int, int] = (6, 14),
    cutoff: float = 4.0,
    seed: int = 0,
) -> List[GraphSample]:
    """Frames interpolated along reactant -> product paths of one
    molecule each, labelled with energy and forces at every
    intermediate geometry."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_reactions):
        n = int(rng.integers(*n_atoms_range))
        z = rng.choice(species, n).astype(np.int64)
        reactant = _packed_positions(n, rng)
        product = reactant + rng.normal(scale=0.5, size=(n, 3))
        for t in np.linspace(0.0, 1.0, frames_per_path):
            pos = ((1 - t) * reactant + t * product).astype(np.float32)
            pos = pos + rng.normal(scale=0.02, size=pos.shape).astype(np.float32)
            energy, forces = morse_energy_forces(pos, z)
            out.append(GraphSample(x=z.reshape(-1, 1).astype(np.float32), pos=pos,
                                   edge_index=radius_graph(pos, cutoff, max_neighbours=24),
                                   energy=energy, forces=forces,
                                   y_graph=np.array([energy], np.float32)))
    return _normalize_energies(out)
