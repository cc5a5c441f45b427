"""Alexandria: formation-energy-style targets on periodic crystals.

Counterpart of ``examples/alexandria/train.py``: alexandria_energy.json's
PNA (hidden 64, 3 layers, periodic) on Ni/Nb/Al/Ti crystals
(``crystals.random_crystals``, seed 11). Per-element reference energies
are fitted on the train split by least squares over element counts
(``data/energy_regression.py``) and subtracted from every split, and
each sample's target is its residual energy per atom.

    python -m hydragnn_tpu_torch.drivers.alexandria --epochs 10
    python -m hydragnn_tpu_torch.drivers.alexandria --device cpu --structures 40 --epochs 2
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.crystals import random_crystals


def residual_splits(n_structures, coeff=None):
    """The crystals' three splits with the element baseline subtracted
    (fitted on the train split, unless ``coeff`` gives it) and per-atom
    residual targets, and the baseline's [118] coefficients."""
    from hydragnn_tpu_torch.data.energy_regression import (
        fit_energy_baseline,
        subtract_energy_baseline,
    )

    tr, va, te = common.split(random_crystals(n_structures, species=(28, 41, 13, 22), seed=11))
    if coeff is None:
        coeff = fit_energy_baseline(tr)

    def residualize(split):
        return [dataclasses.replace(s, y_graph=np.array([s.energy / s.num_nodes], np.float32))
                for s in subtract_energy_baseline(split, coeff)]

    return (residualize(tr), residualize(va), residualize(te)), coeff


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("alexandria", "alexandria_energy.json"))
    ap.add_argument("--structures", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    splits, coeff = residual_splits(args.structures)
    nonzero = int((np.abs(coeff) > 1e-12).sum())
    print(f"energy baseline: {nonzero} element coefficients fitted")
    hist = common.train(config, splits, dev)[3]
    return dict(common.final_losses(hist), baseline_elements=nonzero)


if __name__ == "__main__":
    main()
