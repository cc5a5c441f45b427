"""QM9 graph regression on generated QM9-scale molecules.

Counterpart of ``examples/qm9/qm9.py`` (its ``--synthetic`` path):
qm9.json's SchNet trained on generated molecules (6-23 atoms of H, C,
N, O, F; a weighted-atom-count target; numpy draws in the reference's
order), then the test MAE. The reference's real-QM9 path reads the
dataset through torch_geometric, which the port does not use; the
driver refuses it until QM9's files are in the repository.

    python -m hydragnn_tpu_torch.drivers.qm9 --synthetic --epochs 10
    python -m hydragnn_tpu_torch.drivers.qm9 --device cpu --synthetic --mols 60 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common


def synthetic_qm9(n_mols=400, seed=0):
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(6, 24))
        pos = rng.uniform(0, 1.6 * n ** (1 / 3), (n, 3)).astype(np.float32)
        z = rng.choice([1, 6, 7, 8, 9], n).astype(np.float32)
        ei = radius_graph(pos, 4.0, max_neighbours=24)
        # stand-in target with chemical structure: weighted atom counts
        y = float((z / 9.0).sum() / n)
        out.append(GraphSample(x=z.reshape(-1, 1), pos=pos, edge_index=ei,
                               y_graph=np.array([y], np.float32)))
    return out


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("qm9", "qm9.json"))
    ap.add_argument("--root", default="dataset/qm9",
                    help="the real QM9 (refused: the port has no torch_geometric reader)")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--target", type=int, default=4)  # HOMO-LUMO gap
    ap.add_argument("--mols", type=int, default=400)
    args = ap.parse_args(argv)
    if not args.synthetic:
        ap.error(f"the real QM9 ({args.root}) is read through torch_geometric, which the "
                 "port does not use; pass --synthetic for generated QM9-scale molecules")
    dev = common.device(args)

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import load_config
    from hydragnn_tpu_torch.data.loader import split_dataset

    config = load_config(args.config)
    if args.epochs is not None:
        config["NeuralNetwork"]["Training"]["num_epoch"] = args.epochs

    datasets = split_dataset(synthetic_qm9(args.mols), 0.8)
    state, model, cfg, hist, full = port.run_training(config, datasets=datasets, device=dev)
    err, tasks, trues, preds = port.run_prediction(
        full, datasets=datasets, state=state, model=model, cfg=cfg)
    mae = float(np.mean(np.abs(trues[0] - preds[0])))
    print(f"Test MAE: {mae:.5f}")
    return {"test_mae": mae, "test_error": float(err), "log_name": full["_log_name"],
            "train_loss": [float(v) for v in hist.train_loss]}


if __name__ == "__main__":
    main()
