"""ZINC graph regression with PNAPlus + GPS global attention.

Counterpart of ``examples/zinc/zinc.py``: zinc.json's PNAPlus + GPS (or
zinc_bf16.json's with ``--precision bf16``) on generated ZINC-like bond
graphs: a random tree backbone with ring closures over C, N, O, F and S,
a penalized-logP-like structural target, and the Laplacian and relative
positional encodings GPS needs, from the port's ``ops/pe.py`` (numpy
draws in the reference's order, so a seed gives its molecules bit for
bit).

    python -m hydragnn_tpu_torch.drivers.zinc --epochs 10 [--precision bf16]
    python -m hydragnn_tpu_torch.drivers.zinc --device cpu --mols 80 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common

ATOM_LOGP = {6: 0.34, 7: -0.8, 8: -0.55, 9: 0.2, 16: 0.6}  # C N O F S


def synthetic_zinc(n_mols=400, seed=0):
    """ZINC-like bond graphs: a random tree backbone + ring closures."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.pe import laplacian_pe, relative_pe

    rng = np.random.default_rng(seed)
    types = np.array(list(ATOM_LOGP))
    probs = np.array([0.6, 0.12, 0.16, 0.06, 0.06])
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(12, 33))
        z = rng.choice(types, n, p=probs)
        # Random tree (each atom bonds to an earlier one) + extra ring
        # closures between distant atoms.
        edges = [(i, int(rng.integers(0, i))) for i in range(1, n)]
        n_rings = int(rng.integers(0, 4))
        for _ in range(n_rings):
            a, b = rng.integers(0, n, 2)
            if a != b:
                edges.append((int(a), int(b)))
        snd = np.array([e[0] for e in edges] + [e[1] for e in edges])
        rcv = np.array([e[1] for e in edges] + [e[0] for e in edges])
        ei = np.stack([snd, rcv]).astype(np.int64)
        deg = np.bincount(snd, minlength=n)
        # Penalized-logP-like structural target.
        y = (sum(ATOM_LOGP[int(t)] for t in z) / n + 0.15 * n_rings
             - 0.1 * float((deg > 3).sum()))
        # Bond-graph layout positions (not physical; PNAPlus uses the
        # distances as generic edge geometry).
        pos = rng.uniform(0, n ** (1 / 3), (n, 3)).astype(np.float32)
        pe = laplacian_pe(ei, n, 8)
        out.append(GraphSample(x=z.reshape(-1, 1).astype(np.float32), pos=pos, edge_index=ei,
                               pe=pe, rel_pe=relative_pe(ei, pe),
                               y_graph=np.array([y], np.float32)))
    return out


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="the JSON config (default: examples/zinc/zinc.json, "
                    "zinc_bf16.json with --precision bf16)")
    ap.add_argument("--mols", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--no_gps", action="store_true")
    ap.add_argument("--precision", choices=["fp32", "bf16", "fp64"], default=None,
                    help="override Training.precision; bf16 loads zinc_bf16.json (bf16 "
                    "compute, fp32 master weights)")
    args = ap.parse_args(argv)
    dev = common.device(args)

    from hydragnn_tpu_torch.config import load_config

    cfg_name = "zinc_bf16.json" if args.precision == "bf16" else "zinc.json"
    config = load_config(args.config or common.example_path("zinc", cfg_name))
    if args.precision:
        config["NeuralNetwork"]["Training"]["precision"] = args.precision
    config["NeuralNetwork"]["Training"]["num_epoch"] = args.epochs
    if args.no_gps:
        config["NeuralNetwork"]["Architecture"].pop("global_attn_engine")

    hist = common.train(config, common.split(synthetic_zinc(args.mols)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
