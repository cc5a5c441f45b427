"""OGB-style HOMO-LUMO gap from SMILES strings.

Counterpart of ``examples/ogb/train_gap.py``: the csce driver's random
SMILES (``random_smiles``, imported from it as the reference imports
it) through the native parser into typed-atom nodes and one-hot
bond-class edges, trained with ogb_gap.json's PNA on the edge features;
the target is the normalized-Laplacian spectral gap of the parsed bond
graph.

    python -m hydragnn_tpu_torch.drivers.ogb_gap --epochs 10
    python -m hydragnn_tpu_torch.drivers.ogb_gap --device cpu --mols 80 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.csce_gap import random_smiles, smiles_samples  # noqa: F401

OGB_TYPES = {"C": 0, "F": 1, "H": 2, "N": 3, "O": 4, "S": 5}


def spectral_gap(mol) -> float:
    """Normalized-Laplacian algebraic connectivity of the bond graph."""
    n = mol.num_atoms
    adj = np.zeros((n, n))
    for i, j, _ in mol.bonds:
        adj[i, j] = adj[j, i] = 1.0
    deg = adj.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    lap = np.eye(n) - dinv[:, None] * adj * dinv[None, :]
    return float(np.sort(np.linalg.eigvalsh(lap))[1])


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("ogb", "ogb_gap.json"))
    ap.add_argument("--mols", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    from hydragnn_tpu_torch.utils.smiles import get_node_attribute_name

    config = common.example_config(args)
    names, _ = get_node_attribute_name(OGB_TYPES)
    config["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = list(
        range(len(names)))

    splits = common.split(smiles_samples(args.mols, OGB_TYPES, spectral_gap))
    return common.final_losses(common.train(config, splits, dev)[3])


if __name__ == "__main__":
    main()
