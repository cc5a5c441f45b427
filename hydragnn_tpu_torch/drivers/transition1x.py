"""Transition1x: energies along reaction pathways.

Counterpart of ``examples/transition1x/train.py``:
transition1x_energy.json's PNAPlus on geometries interpolated along
reactant -> product paths of random HCNO molecules, each frame labelled
with its Morse energy (``molecules.reaction_path_frames``).

    python -m hydragnn_tpu_torch.drivers.transition1x --epochs 10
    python -m hydragnn_tpu_torch.drivers.transition1x --device cpu --reactions 6 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import reaction_path_frames


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("transition1x", "transition1x_energy.json"))
    ap.add_argument("--reactions", type=int, default=40)
    ap.add_argument("--frames_per_path", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    samples = reaction_path_frames(args.reactions, frames_per_path=args.frames_per_path)
    hist = common.train(config, common.split(samples), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
