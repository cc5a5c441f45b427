"""MPTrj: energies (or energies and forces) of relaxation-trajectory crystals.

Counterpart of ``examples/mptrj/train.py``: mptrj_energy.json's SAGE
(graph energy head) or, with ``--forces``, mptrj_forces.json's EGNN
potential, on periodic Ni/Nb/Al/Ti crystals with species-pair
Lennard-Jones energies and forces (``crystals.random_crystals``, seed
3). The MPTrj JSON download needs a network; the crystals are the
reference driver's stand-in, bit for bit.

    python -m hydragnn_tpu_torch.drivers.mptrj --epochs 10
    python -m hydragnn_tpu_torch.drivers.mptrj --forces --device cpu --structures 40 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.crystals import random_crystals


def mptrj_samples(n_structures):
    return random_crystals(n_structures, species=(28, 41, 13, 22), seed=3)


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("mptrj", "mptrj_energy.json"),
                       alt=("forces", "train the interatomic-potential config",
                            ("mptrj", "mptrj_forces.json")))
    ap.add_argument("--structures", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(mptrj_samples(args.structures)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
