"""Open Catalyst 2025: one potential over periodic and gas-phase systems.

Counterpart of ``examples/open_catalyst_2025/train.py``: oc25_energy.json's
PaiNN potential (hidden 32, 3 layers; energy and energy-conserving
forces) trained on a mix of periodic slabs (the OC20 driver's, seed 25:
``cell`` and ``edge_shifts`` set) and gas-phase molecular frames
(``molecules.random_molecule_frames``, seed 26: neither, and their
``y_graph`` removed so that label presence is uniform), shuffled
together by a generator of seed 0. The loader's optional-field map
(``graph.optional_field_widths``) zero-fills ``cell`` and
``edge_shifts`` on the gas-phase side, so every batch has one structure.

    python -m hydragnn_tpu_torch.drivers.oc25 --epochs 8
    python -m hydragnn_tpu_torch.drivers.oc25 --device cpu --systems 40 --epochs 2
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames
from hydragnn_tpu_torch.drivers.oc20 import synthetic_oc20


def mixed_samples(n_systems):
    """Half periodic slabs, half gas-phase frames, shuffled."""
    n_half = n_systems // 2
    slabs = synthetic_oc20(n_half, seed=25)
    gas = [dataclasses.replace(s, y_graph=None) for s in random_molecule_frames(n_half, seed=26)]
    samples = list(slabs) + gas
    np.random.default_rng(0).shuffle(samples)
    return samples


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("open_catalyst_2025", "oc25_energy.json"))
    ap.add_argument("--systems", type=int, default=160)
    ap.add_argument("--epochs", type=int, default=8)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(mixed_samples(args.systems)), dev)[3]
    return common.with_force_loss(hist, common.final_losses(hist))


if __name__ == "__main__":
    main()
