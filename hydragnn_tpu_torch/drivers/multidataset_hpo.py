"""Multi-dataset HPO: every trial a two-family GFM ``run_training``.

Counterpart of ``examples/multidataset_hpo/train.py``: ``utils/hpo.
random_search`` over the width, depth and learning rate of
gfm_energy.json's SchNet (read in place, its branch list cut to the
first two: "molecules" and "crystals"), each trial one shared encoder
trained on the multidataset driver's molecule and crystal families
(``dataset_id`` set, shuffled by a generator of seed 0, split 0.8).

    python -m hydragnn_tpu_torch.drivers.multidataset_hpo --trials 4 --epochs 3
    python -m hydragnn_tpu_torch.drivers.multidataset_hpo --device cpu --per_family 20 \\
        --trials 1 --epochs 1
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.multidataset import families, mixed_samples

SPACE = {
    "NeuralNetwork.Architecture.hidden_dim": [32, 64],
    "NeuralNetwork.Architecture.num_conv_layers": [2, 3],
    "NeuralNetwork.Training.Optimizer.learning_rate": [0.001, 0.002],
}


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("multidataset", "gfm_energy.json"))
    ap.add_argument("--per_family", type=int, default=120)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args(argv)
    dev = common.device(args)

    from hydragnn_tpu_torch.utils.hpo import random_search

    base = common.example_config(args)
    heads = base["NeuralNetwork"]["Architecture"]["output_heads"]
    heads["graph"] = heads["graph"][:2]  # two families keep the search fast
    datasets = common.split(mixed_samples(families(args.per_family, reactions=False)))
    best_params, best_val, trials = random_search(base, SPACE, n_trials=args.trials,
                                                  datasets=datasets, seed=0, device=dev)
    for params, value in trials:
        print(f"trial val {value:.5f}  {params}")
    print(f"best: val {best_val:.5f} params {best_params}")
    return {"best_params": best_params, "best_val": float(best_val),
            "trials": [(p, float(v)) for p, v in trials]}


if __name__ == "__main__":
    main()
