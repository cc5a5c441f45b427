"""ANI-1x: many small HCNO molecules x many conformations.

Counterpart of ``examples/ani1_x/train.py``: ani1x_energy.json's SchNet
(energy only) or, with ``--mlip``, ani1x_mlip.json's PaiNN potential
(energy and energy-conserving forces) on thermal frames of 16 random
HCNO molecules with Morse energies and forces
(``molecules.random_molecule_frames``, one-hot node features).

    python -m hydragnn_tpu_torch.drivers.ani1x --mlip --epochs 10
    python -m hydragnn_tpu_torch.drivers.ani1x --device cpu --frames 60 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames


def ani1x_samples(n_frames):
    return random_molecule_frames(n_frames, species=(1, 6, 7, 8), n_molecules=16,
                                  feature="onehot")


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("ani1_x", "ani1x_energy.json"),
                       alt=("mlip", "train energy+forces (ani1x_mlip.json) instead of "
                            "energy-only", ("ani1_x", "ani1x_mlip.json")))
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(ani1x_samples(args.frames)), dev)[3]
    out = common.final_losses(hist)
    return common.with_force_loss(hist, out) if args.mlip else out


if __name__ == "__main__":
    main()
