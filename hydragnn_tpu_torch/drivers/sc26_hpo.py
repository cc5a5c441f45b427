"""SC26 model-family search: SchNet, EGNN and PaiNN potentials compared.

Counterpart of ``examples/multidataset_hpo_sc26/train_hpo.py``: a search
whose space holds the MPNN type itself (SchNet, EGNN, PAINN) beside the
width and the learning rate, each trial an energy + force potential
(``run_trial``: one ``run_training``) on the same molecular frames
(``molecules.random_molecule_frames``, seed 0, split 0.8). The grid is
every combination (``itertools.product`` over ``SPACE``), shuffled by a
generator of ``--seed``, then strided across a fleet of workers
(``combos[worker::num_workers]``, a partition with no repeated trial)
and cut to ``--trials``; the trials run one after another.

    python -m hydragnn_tpu_torch.drivers.sc26_hpo --trials 3
    python -m hydragnn_tpu_torch.drivers.sc26_hpo --device cpu --frames 20 --trials 2 \\
        --epochs 1 --worker 1 --num-workers 2
"""

from __future__ import annotations

import itertools

import numpy as np

from hydragnn_tpu_torch.drivers import common

SPACE = {
    "NeuralNetwork.Architecture.mpnn_type": ["SchNet", "EGNN", "PAINN"],
    "NeuralNetwork.Architecture.hidden_dim": [16, 32],
    "NeuralNetwork.Training.Optimizer.learning_rate": [0.002, 0.005],
}


def base_config(epochs, batch_size):
    """The reference's base config: a SchNet energy + force potential
    (hidden 16, 2 layers, sum pooling, force weight 10)."""
    return {
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet",
                "radius": 4.0,
                "max_neighbours": 24,
                "num_gaussians": 12,
                "num_radial": 12,
                "num_filters": 16,
                "hidden_dim": 16,
                "num_conv_layers": 2,
                "graph_pooling": "add",
                "enable_interatomic_potential": True,
                "energy_weight": 1.0,
                "force_weight": 10.0,
                "output_heads": {
                    "graph": {
                        "num_sharedlayers": 1,
                        "dim_sharedlayers": 16,
                        "num_headlayers": 1,
                        "dim_headlayers": [16],
                    }
                },
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["energy"],
                "output_index": [0],
                "type": ["graph"],
                "output_dim": [1],
            },
            "Training": {
                "num_epoch": epochs,
                "batch_size": batch_size,
                "perc_train": 0.8,
                "Optimizer": {"type": "AdamW", "learning_rate": 2e-3},
            },
        },
    }


def worker_combos(seed: int, worker: int, num_workers: int, trials: int):
    """This worker's trials: the shuffled grid strided by the fleet."""
    keys = list(SPACE)
    combos = [dict(zip(keys, vals)) for vals in itertools.product(*SPACE.values())]
    np.random.default_rng(seed).shuffle(combos)
    return combos[worker::num_workers][:trials]


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0,
                    help="shuffle seed for the search-space order; the SAME on every fleet "
                    "worker (partitioning is by --worker index, not by seed)")
    ap.add_argument("--worker", type=int, default=0,
                    help="this worker's index in a fleet campaign")
    ap.add_argument("--num-workers", type=int, default=1,
                    help="fleet size; the shuffled search grid is strided "
                    "worker::num_workers, a true partition with no duplicated trials")
    args = ap.parse_args(argv)
    dev = common.device(args)

    from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames
    from hydragnn_tpu_torch.utils.hpo import run_trial

    # the same data set on every worker, so that val losses compare
    datasets = common.split(random_molecule_frames(args.frames, seed=0))
    base = base_config(args.epochs, 8)
    mine = worker_combos(args.seed, args.worker, args.num_workers, args.trials)
    trials = [(params, run_trial(base, params, datasets, device=dev)) for params in mine]
    for params, value in trials:
        print(f"trial val {value:.5f}  "
              f"{params['NeuralNetwork.Architecture.mpnn_type']:7s} {params}")
    best_params, best_val = min(trials, key=lambda t: t[1])
    print(f"best: val {best_val:.5f} params {best_params}")
    return {"best_params": best_params, "best_val": float(best_val),
            "trials": [(p, float(v)) for p, v in trials]}


if __name__ == "__main__":
    main()
