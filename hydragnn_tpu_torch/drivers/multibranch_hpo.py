"""Multibranch HPO: every trial a multibranch ``run_training``.

Counterpart of ``examples/multibranch_hpo/train.py``: ``utils/hpo.
random_search`` over SchNet's width, depth and learning rate, each trial
a ``run_training`` under ``Parallelism.scheme "multibranch"``, one shared
encoder and a decoder branch a data set, on the multibranch driver's
branch sets (``multibranch.make_branch_dataset``) each split 0.75 into
the scheme's per-branch (train, val, test) triples.

It runs on ranks as ``drivers/multibranch.py`` does (alone it starts
``--ranks`` processes of itself, one per branch by default; under
``torchrun`` it joins the group it finds). Every rank runs the same
search (same seed) in lockstep, and rank 0 prints. On the card each rank
also reports, per trial, its K1/K2 launches beside its forwards and
train steps (``train/loop.DISPATCHES``).

    python -m hydragnn_tpu_torch.drivers.multibranch_hpo --trials 3 --epochs 3
    python -m hydragnn_tpu_torch.drivers.multibranch_hpo --device cpu --trials 1 --epochs 1 \\
        --sizes 24 12
"""

from __future__ import annotations

import sys
import time

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.multibranch import launch_counts, make_branch_dataset

MODULE = "hydragnn_tpu_torch.drivers.multibranch_hpo"

SPACE = {
    "NeuralNetwork.Architecture.hidden_dim": [16, 32],
    "NeuralNetwork.Architecture.num_conv_layers": [2, 3],
    "NeuralNetwork.Training.Optimizer.learning_rate": [0.002, 0.005],
}


def base_config(epochs, batch_size, n_branches):
    """The reference's base config: SchNet with a graph head on
    ``n_branches`` branches, under the multibranch scheme."""
    return {
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet",
                "radius": 2.5,
                "max_neighbours": 12,
                "num_gaussians": 12,
                "num_filters": 16,
                "hidden_dim": 16,
                "num_conv_layers": 2,
                "output_heads": {
                    "graph": [
                        {
                            "type": f"branch-{i}",
                            "architecture": {
                                "num_sharedlayers": 1,
                                "dim_sharedlayers": 16,
                                "num_headlayers": 1,
                                "dim_headlayers": [16],
                            },
                        }
                        for i in range(n_branches)
                    ]
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
                "num_epoch": epochs,
                "batch_size": batch_size,
                "Parallelism": {"scheme": "multibranch"},
                "Optimizer": {"type": "AdamW", "learning_rate": 2e-3},
            },
        },
    }


def branch_splits(sizes):
    """Each branch's set split 0.75 into (train, val, test)."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    return [split_dataset(make_branch_dataset(n, 1.0 + bi, seed=bi), 0.75)
            for bi, n in enumerate(sizes)]


def _parser():
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--sizes", type=int, nargs="+", default=[160, 80])
    common.rank_arguments(ap)
    return ap


def run_rank(args, joined: bool) -> dict:
    """The search on this rank (rank 0 prints)."""
    import torch
    import torch.distributed as dist

    from hydragnn_tpu_torch.train.loop import DISPATCHES
    from hydragnn_tpu_torch.utils.hpo import random_search, run_trial

    dev = common.join(args)[0] if joined else common.device(args)
    rank = dist.get_rank() if joined else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    datasets = branch_splits(args.sizes)
    base = base_config(args.epochs, args.batch_size, len(args.sizes))
    calls = []

    def objective(config, params):
        k0, d0 = launch_counts(), dict(DISPATCHES)
        value = run_trial(config, params, datasets=datasets, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            k1, k2 = (c - b for c, b in zip(launch_counts(), k0))
            arch = {k.rsplit(".", 1)[-1]: v for k, v in params.items()}
            calls.append({"call": "run_training", "k1": k1, "k2": k2,
                          "forwards": DISPATCHES["forwards"] - d0["forwards"],
                          "train_steps": DISPATCHES["train_steps"] - d0["train_steps"],
                          "mpnn_type": "SchNet", "num_conv_layers": arch["num_conv_layers"],
                          "potential": False})
        return value

    t0 = time.perf_counter()
    best_params, best_val, trials = random_search(base, SPACE, n_trials=args.trials, seed=0,
                                                  objective=objective)
    for params, value in trials:
        say(f"trial val {value:.5f}  {params}")
    say(f"best: val {best_val:.5f} params {best_params}")
    out = {"rank": rank, "best_params": best_params, "best_val": float(best_val),
           "trials": [(p, float(v)) for p, v in trials], "seconds": time.perf_counter() - t0}
    if calls:
        out["calls"] = calls
    if joined:
        common.write_rank_output(args, out)
        dist.destroy_process_group()
    return out


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.rank is not None or common.launched():
        return run_rank(args, joined=True)
    ranks = len(args.sizes) if args.ranks is None else args.ranks
    outs = ([run_rank(args, joined=False)] if ranks == 1
            else common.spawn_ranks(MODULE, argv, ranks, args))
    return dict(outs[0], ranks=outs)


if __name__ == "__main__":
    main()
