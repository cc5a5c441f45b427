"""QM7-X: equilibrium and perturbed conformations of small organic molecules.

Counterpart of ``examples/qm7x/train.py``: qm7x.json's DimeNet++
(energy only) or, with ``--mlip``, qm7x_mlip.json's SchNet potential, on
thermal frames of 14 random HCNOS molecules of 4-11 atoms with Morse
energies and forces (``build_dataset``: ``molecules.random_molecule_frames``,
seed 7, one-hot node features). The run's checkpoint under
``logs/<log_name>`` is what ``qm7x_inference`` predicts from.

    python -m hydragnn_tpu_torch.drivers.qm7x --epochs 10
    python -m hydragnn_tpu_torch.drivers.qm7x --mlip --device cpu --frames 60 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames

CONFIGS = (("qm7x", "qm7x.json"),
           ("mlip", "interatomic potential (qm7x_mlip.json)", ("qm7x", "qm7x_mlip.json")))


def build_dataset(frames, seed=7):
    return random_molecule_frames(frames, species=(1, 6, 7, 8, 16), n_atoms_range=(4, 12),
                                  n_molecules=14, seed=seed, feature="onehot")


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], *CONFIGS)
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(build_dataset(args.frames)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
