"""QM9 hyperparameter search, every trial a short ``run_training``.

Counterpart of ``examples/qm9_hpo/qm9_hpo.py``: ``utils/hpo.random_search``
over SchNet and PNA, widths, depths and learning rates on the qm9
driver's generated molecules (``drivers/qm9.synthetic_qm9``), selecting
by the best validation loss. The trials run one after another in this
process; each trial's graph cache and checkpoint writer are released
before the next starts, and on the card the device memory held after
each trial is reported.

    python -m hydragnn_tpu_torch.drivers.qm9_hpo --trials 6 --epochs 4
    python -m hydragnn_tpu_torch.drivers.qm9_hpo --device cpu --trials 2 --epochs 1 --mols 40
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common


def hpo_config(epochs: int) -> dict:
    """The reference driver's base config."""
    return {
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet",
                "radius": 4.0,
                "max_neighbours": 24,
                "num_gaussians": 24,
                "num_filters": 32,
                "hidden_dim": 32,
                "num_conv_layers": 3,
                "output_heads": {
                    "graph": {
                        "num_sharedlayers": 1,
                        "dim_sharedlayers": 32,
                        "num_headlayers": 2,
                        "dim_headlayers": [32, 32],
                    }
                },
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["y"],
                "output_index": [0],
                "type": ["graph"],
                "output_dim": [1],
            },
            "Training": {
                "batch_size": 32,
                "num_epoch": epochs,
                "Optimizer": {"type": "AdamW", "learning_rate": 1e-3},
            },
        }
    }


SPACE = {
    "NeuralNetwork.Architecture.hidden_dim": [16, 32, 64],
    "NeuralNetwork.Architecture.num_conv_layers": [2, 3, 4],
    "NeuralNetwork.Training.Optimizer.learning_rate": [3e-3, 1e-3, 3e-4],
    "NeuralNetwork.Architecture.mpnn_type": ["SchNet", "PNA"],
}


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--mols", type=int, default=200)
    args = ap.parse_args(argv)
    dev = common.device(args)

    import torch

    from hydragnn_tpu_torch.data.loader import split_dataset
    from hydragnn_tpu_torch.drivers.qm9 import synthetic_qm9
    from hydragnn_tpu_torch.utils.hpo import random_search, run_trial

    datasets = split_dataset(synthetic_qm9(args.mols, seed=0), 0.8)
    device_mib = []

    def objective(config, params):
        value = run_trial(config, params, datasets=datasets, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            device_mib.append(torch.cuda.memory_allocated(dev) / 2**20)
        return value

    best_params, best_val, trials = random_search(
        hpo_config(args.epochs), SPACE, n_trials=args.trials, seed=0, objective=objective)
    for params, value in trials:
        short = {k.split(".")[-1]: v for k, v in params.items()}
        print(f"trial {short} -> val {value:.5f}")
    print(f"best: {best_params} (val {best_val:.5f})")
    if device_mib:
        print(f"device memory after each trial: {[round(m, 2) for m in device_mib]} MiB")
    return {"best_params": best_params, "best_val": float(best_val),
            "trials": [(p, float(v)) for p, v in trials], "device_mib": device_mib}


if __name__ == "__main__":
    main()
