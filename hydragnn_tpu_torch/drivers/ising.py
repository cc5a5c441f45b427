"""Ising model: the energy (graph head) and local fields (node head).

Counterpart of ``examples/ising_model/ising.py``: spins on cubic lattices
of 2-3 sites a side; PNA (hidden 32, 3 layers) learns the Ising energy
per site, ``E = -J sum_<ij> s_i s_j`` over nearest-neighbour pairs, and
each site's local field ``h_i = sum_{j in N(i)} s_j`` (an ``mlp`` node
head) together. The neighbours come from the radius graph of the exact
lattice, before the positions are jittered (seed 0; the reference's
draws in its order).

    python -m hydragnn_tpu_torch.drivers.ising --epochs 10
    python -m hydragnn_tpu_torch.drivers.ising --device cpu --configs 40 --epochs 1
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common

J = 1.0
A = 1.0  # lattice constant


def synthetic_ising(n_configs=300, seed=0):
    """``n_configs`` random spin configurations on random lattices."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_configs):
        nx, ny, nz = rng.integers(2, 4, 3)
        grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
                        axis=-1).reshape(-1, 3) * A
        n = len(grid)
        spins = rng.choice([-1.0, 1.0], n)
        ei = radius_graph(grid, 1.01 * A, max_neighbours=6)
        snd, rcv = ei
        energy = -J * float(np.sum(spins[snd] * spins[rcv])) / 2.0
        field = np.zeros(n)
        np.add.at(field, rcv, spins[snd])
        pos = grid + rng.normal(scale=0.02, size=grid.shape)
        out.append(GraphSample(x=spins.reshape(-1, 1).astype(np.float32),
                               pos=pos.astype(np.float32), edge_index=ei,
                               y_graph=np.array([energy / n], np.float32),
                               y_node=field.reshape(-1, 1).astype(np.float32)))
    return out


def ising_config(epochs: int) -> dict:
    """The reference's inline config."""
    return {
        "Verbosity": {"level": 1},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "PNA",
                "radius": 1.01 * A,
                "max_neighbours": 6,
                "hidden_dim": 32,
                "num_conv_layers": 3,
                "output_heads": {
                    "graph": {
                        "num_sharedlayers": 1,
                        "dim_sharedlayers": 32,
                        "num_headlayers": 2,
                        "dim_headlayers": [32, 32],
                    },
                    "node": {
                        "num_headlayers": 2,
                        "dim_headlayers": [32, 32],
                        "type": "mlp",
                    },
                },
                "task_weights": [1.0, 1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["energy_per_site", "local_field"],
                "output_index": [0, 0],
                "type": ["graph", "node"],
                "output_dim": [1, 1],
            },
            "Training": {
                "batch_size": 16,
                "num_epoch": epochs,
                "Optimizer": {"type": "AdamW", "learning_rate": 3e-3},
            },
        },
    }


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--configs", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    hist = common.train(ising_config(args.epochs), common.split(synthetic_ising(args.configs)),
                        dev)[3]
    tasks = np.asarray(hist.test_tasks[-1]).reshape(-1)
    out = {"train_loss": float(hist.train_loss[-1]), "test_loss": float(hist.test_loss[-1]),
           "energy_loss": float(tasks[0]), "field_loss": float(tasks[1])}
    print(f"final: train {out['train_loss']:.5f} test {out['test_loss']:.5f} "
          f"| energy {out['energy_loss']:.5f} field {out['field_loss']:.5f}")
    return out


if __name__ == "__main__":
    main()
