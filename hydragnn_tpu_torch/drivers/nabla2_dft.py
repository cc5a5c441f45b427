"""nabla2-DFT: conformational energies of drug-like molecules.

Counterpart of ``examples/nabla2_dft/train.py``: nabla2_dft.json's PaiNN
(energy only) on few molecules x many conformations: 8 random HCNOS
molecules of 12-23 atoms, jitter 0.14, Morse energies
(``molecules.random_molecule_frames``, seed 17, one-hot node features).

    python -m hydragnn_tpu_torch.drivers.nabla2_dft --epochs 10
    python -m hydragnn_tpu_torch.drivers.nabla2_dft --device cpu --frames 60 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames


def nabla2_samples(n_frames):
    return random_molecule_frames(n_frames, species=(1, 6, 7, 8, 16), n_atoms_range=(12, 24),
                                  n_molecules=8, jitter=0.14, seed=17, feature="onehot")


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("nabla2_dft", "nabla2_dft.json"))
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(nabla2_samples(args.frames)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
