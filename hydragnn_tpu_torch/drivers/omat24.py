"""Open Materials 2024: a potential on off-equilibrium inorganic crystals.

Counterpart of ``examples/open_materials_2024/train.py``:
omat24_forces.json's SchNet potential (energy, energy per atom and
forces; periodic) on rattled Ni/Nb/Al/Ti crystals with 10% vacancies
(``crystals.random_crystals``, seed 24).

    python -m hydragnn_tpu_torch.drivers.omat24 --epochs 10
    python -m hydragnn_tpu_torch.drivers.omat24 --device cpu --structures 40 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.crystals import random_crystals


def omat24_samples(n_structures):
    return random_crystals(n_structures, species=(28, 41, 13, 22), jitter=0.06,
                           vacancy_rate=0.10, seed=24)


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("open_materials_2024", "omat24_forces.json"))
    ap.add_argument("--structures", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(omat24_samples(args.structures)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
