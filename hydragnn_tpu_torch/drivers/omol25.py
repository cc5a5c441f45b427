"""Open Molecules 2025: energies of larger organic molecules.

Counterpart of ``examples/open_molecules_2025/train.py``:
omol25_energy.json's PNAPlus on 20 random HCNOS molecules of 18-31
atoms (cutoff 4.5, 28 neighbours), Morse energies
(``molecules.random_molecule_frames``, seed 25, one-hot node features).

    python -m hydragnn_tpu_torch.drivers.omol25 --epochs 10
    python -m hydragnn_tpu_torch.drivers.omol25 --device cpu --frames 60 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames


def omol25_samples(n_frames):
    return random_molecule_frames(n_frames, species=(1, 6, 7, 8, 16), n_atoms_range=(18, 32),
                                  n_molecules=20, cutoff=4.5, max_neighbours=28, seed=25,
                                  feature="onehot")


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("open_molecules_2025", "omol25_energy.json"))
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(omol25_samples(args.frames)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
