"""QCML: energies of small molecules across broad chemical space.

Counterpart of ``examples/qcml/train.py``: qcml_energy.json's MACE
(hidden 16, energy only) on 24 random HCNOS molecules of 4-9 atoms with
Morse energies (``molecules.random_molecule_frames``, seed 41, Z as the
node feature).

    python -m hydragnn_tpu_torch.drivers.qcml --epochs 10
    python -m hydragnn_tpu_torch.drivers.qcml --device cpu --frames 60 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames


def qcml_samples(n_frames):
    return random_molecule_frames(n_frames, species=(1, 6, 7, 8, 16), n_atoms_range=(4, 10),
                                  n_molecules=24, seed=41)


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("qcml", "qcml_energy.json"))
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(qcml_samples(args.frames)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
