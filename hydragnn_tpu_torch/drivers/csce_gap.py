"""CSCE band gap from SMILES strings.

Counterpart of ``examples/csce/train_gap.py``: gap regression over
molecules ingested from SMILES through the port's native parser
(``utils/smiles.py``: [atom-type one-hot | Z | aromatic | sp | sp2 |
sp3 | num H] node features, one-hot bond-class edges) with csce_gap.json's
GAT. The SMILES are random small molecules from organic fragments
(``random_smiles``; numpy draws in the reference's order) and the
target a closed-form "gap-like" score of the parsed molecule.

    python -m hydragnn_tpu_torch.drivers.csce_gap --epochs 10
    python -m hydragnn_tpu_torch.drivers.csce_gap --device cpu --mols 80 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common

#: reference csce node types
CSCE_TYPES = {"C": 0, "F": 1, "H": 2, "N": 3, "O": 4, "S": 5}

_CHAIN = ("C", "C", "C", "N", "O", "S", "F")
_RINGS = ("c1ccccc1", "c1ccncc1", "c1ccoc1", "c1ccsc1")


def random_smiles(rng) -> str:
    """A small random valid SMILES: chain + optional branch + optional
    aromatic ring, drawn from the csce element set."""
    parts = []
    for _ in range(int(rng.integers(1, 5))):
        atom = str(rng.choice(_CHAIN))
        if atom == "F" and parts:
            parts.append("(F)")  # halogens terminate; branch them
            continue
        parts.append(atom)
    if rng.random() < 0.4:
        parts.append("(" + "C" * int(rng.integers(1, 3)) + ")")
    if rng.random() < 0.5:
        parts.append(str(rng.choice(_RINGS)))
    smi = "".join(parts)
    return smi if smi[0] != "(" else "C" + smi


def gap_target(mol) -> float:
    """Closed-form target: aromatic fraction narrows the 'gap',
    electronegative heteroatoms widen it."""
    z = np.asarray(mol.atomic_numbers, dtype=np.float64)
    arom = float(np.mean(np.asarray(mol.aromatic, dtype=np.float64)))
    hetero = float(np.mean((z > 6) & (z != 1)))
    return 2.0 - 1.5 * arom + 0.8 * hetero


def smiles_samples(n_mols, types, target, seed=0):
    """``n_mols`` random SMILES featurized with ``types``, each labelled
    ``target(parsed molecule)``: the reference drivers' sample loop."""
    from hydragnn_tpu_torch.utils.smiles import graph_sample_from_smiles, parse_smiles

    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n_mols):
        smi = random_smiles(rng)
        mol = parse_smiles(smi)  # H-materialized; reused below
        samples.append(graph_sample_from_smiles(smi, [target(mol)], types, mol=mol))
    return samples


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("csce", "csce_gap.json"))
    ap.add_argument("--mols", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    from hydragnn_tpu_torch.utils.smiles import get_node_attribute_name

    config = common.example_config(args)
    names, _ = get_node_attribute_name(CSCE_TYPES)
    config["NeuralNetwork"]["Variables_of_interest"]["input_node_features"] = list(
        range(len(names)))

    splits = common.split(smiles_samples(args.mols, CSCE_TYPES, gap_target))
    return common.final_losses(common.train(config, splits, dev)[3])


if __name__ == "__main__":
    main()
