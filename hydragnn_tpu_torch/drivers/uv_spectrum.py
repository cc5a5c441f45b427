"""UV/vis spectra: a 50-bin spectrum per molecule from one graph head.

Counterpart of ``examples/dftb_uv_spectrum/uv_spectrum.py``: GIN (hidden
64, 3 layers) with one 50-wide graph head regressing a discretized
spectrum, on synthetic molecules whose spectrum is a sum of Gaussian
peaks placed by the normalized bond lengths and weighted by the bonded
atoms' mean atomic number (seed 0; the reference's draws in its order).
GIN sums its messages through ``segment_sum`` in both packages, so this
driver launches no K1/K2.

    python -m hydragnn_tpu_torch.drivers.uv_spectrum --epochs 10
    python -m hydragnn_tpu_torch.drivers.uv_spectrum --device cpu --mols 40 --epochs 1
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common

N_BINS = 50


def synthetic_spectra(n_mols=300, seed=0):
    """``n_mols`` molecules of 8-19 atoms (H, C, N, O) with their
    spectra in ``y_graph``."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    grid = np.linspace(0.0, 1.0, N_BINS)
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(8, 20))
        pos = rng.uniform(0, 1.8 * n ** (1 / 3), (n, 3)).astype(np.float32)
        z = rng.choice([1.0, 6.0, 7.0, 8.0], n, p=[0.4, 0.4, 0.1, 0.1])
        ei = radius_graph(pos, 3.0, max_neighbours=16)
        snd, rcv = ei
        d = np.linalg.norm(pos[snd] - pos[rcv], axis=1)
        # peaks at the normalized bond lengths, heights from the pair's
        # mean atomic number
        centers = np.clip(d / 3.0, 0.0, 1.0)
        heights = (z[snd] + z[rcv]) / 16.0
        spec = np.zeros(N_BINS)
        for c, h in zip(centers, heights):
            spec += h * np.exp(-(((grid - c) / 0.05) ** 2))
        spec /= max(len(d), 1)
        out.append(GraphSample(x=z.reshape(-1, 1).astype(np.float32), pos=pos, edge_index=ei,
                               y_graph=spec.astype(np.float32)))
    return out


def spectrum_config(epochs: int) -> dict:
    """The reference's inline config."""
    return {
        "Verbosity": {"level": 1},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "GIN",
                "radius": 3.0,
                "max_neighbours": 16,
                "hidden_dim": 64,
                "num_conv_layers": 3,
                "output_heads": {
                    "graph": {
                        "num_sharedlayers": 2,
                        "dim_sharedlayers": 64,
                        "num_headlayers": 2,
                        "dim_headlayers": [128, 128],
                    }
                },
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["uv_spectrum"],
                "output_index": [0],
                "type": ["graph"],
                "output_dim": [N_BINS],
            },
            "Training": {
                "batch_size": 32,
                "num_epoch": epochs,
                "Optimizer": {"type": "AdamW", "learning_rate": 2e-3},
            },
        },
    }


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--mols", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    hist = common.train(spectrum_config(args.epochs),
                        common.split(synthetic_spectra(args.mols)), dev)[3]
    out = {"train_loss": float(hist.train_loss[-1]), "val_loss": float(hist.val_loss[-1]),
           "test_loss": float(hist.test_loss[-1])}
    print(f"final: train {out['train_loss']:.6f} val {out['val_loss']:.6f} "
          f"test {out['test_loss']:.6f} ({N_BINS}-dim spectrum head)")
    return out


if __name__ == "__main__":
    main()
