"""Open Catalyst 2020 S2EF: energies and forces of catalyst slabs.

Counterpart of ``examples/open_catalyst_2020/oc20.py``: oc20.json's
MACE potential (hidden 32, 2 layers) trained on slab + adsorbate
systems under periodic boundary conditions. The OC20 LMDB download
needs a network, so the systems are the reference driver's stand-in
(``synthetic_oc20``): a 2-3 x 2-3 x 2 simple-cubic Cu slab with 8%
vacancies and a 1-3 atom H/C/O chain above a surface site, jittered,
with Lennard-Jones energies and forces under PBC (``lj_data``'s
machinery; numpy draws in the reference's order, so a seed gives its
systems bit for bit).

    python -m hydragnn_tpu_torch.drivers.oc20 --epochs 8
    python -m hydragnn_tpu_torch.drivers.oc20 --device cpu --systems 40 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common


def synthetic_oc20(n_systems=200, seed=0, cutoff=5.0):
    """Slab + adsorbate periodic systems with LJ energies and forces."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.drivers.lj_data import LATTICE_CONSTANT, lj_energy_forces
    from hydragnn_tpu_torch.ops.neighbors import radius_graph_pbc

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_systems):
        nx, ny = int(rng.integers(2, 4)), int(rng.integers(2, 4))
        nz = 2
        a = LATTICE_CONSTANT
        cell = np.diag([nx * a, ny * a, nz * a * 3.0]).astype(np.float64)
        grid = np.stack(np.meshgrid(np.arange(nx) * a, np.arange(ny) * a, np.arange(nz) * a,
                                    indexing="ij"), axis=-1).reshape(-1, 3)
        slab = grid[rng.random(len(grid)) > 0.08]  # vacancies
        # the adsorbate: a short chain above a random surface site, at
        # LJ-reasonable distances (sigma 2.5: equilibrium ~2.8)
        n_ads = int(rng.integers(1, 4))
        site = slab[rng.integers(0, len(slab))]
        height = slab[:, 2].max() + rng.uniform(2.6, 3.2)
        ads = np.stack([site[0] + np.arange(n_ads) * 2.6, np.full(n_ads, site[1]),
                        np.full(n_ads, height)], axis=1)
        ads = ads + rng.normal(scale=0.05, size=(n_ads, 3))
        pos = np.concatenate([slab, ads]) + rng.normal(scale=0.05,
                                                       size=(len(slab) + n_ads, 3))
        pos = pos.astype(np.float64)
        z = np.concatenate([np.full(len(slab), 29.0),  # Cu slab
                            rng.choice([1.0, 6.0, 8.0], n_ads)]).astype(np.float32)
        ei, shifts = radius_graph_pbc(pos, cell, cutoff)
        energy, forces = lj_energy_forces(pos, cell, cutoff, neighbors=(ei, shifts))
        out.append(GraphSample(x=z.reshape(-1, 1), pos=pos.astype(np.float32), edge_index=ei,
                               edge_shifts=shifts.astype(np.float32),
                               cell=cell.astype(np.float32), energy=energy, forces=forces))
    return out


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("open_catalyst_2020", "oc20.json"))
    ap.add_argument("--systems", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--mpnn_type", default=None, help="override config")
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    if args.mpnn_type:
        config["NeuralNetwork"]["Architecture"]["mpnn_type"] = args.mpnn_type
    splits = common.split(synthetic_oc20(args.systems))
    hist = common.train(config, splits, dev)[3]
    return common.with_force_loss(hist, common.final_losses(hist))


if __name__ == "__main__":
    main()
