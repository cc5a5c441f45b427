"""Multi-dataset GFM: one encoder, a decoder branch per data-set family.

Counterpart of ``examples/multidataset/train.py`` with gfm_energy.json:
one SchNet encoder (hidden 64, 3 layers) trained in one process on a
mixture of three families, each sample routed by its ``dataset_id`` to
its family's graph-head branch ("molecules", "crystals", "reactions";
``models/base.py``): gas-phase molecular frames (seed 0), periodic
crystals with per-atom energies (seed 1; ``cell`` and ``edge_shifts``
set) and reaction-path frames (one path per ten, seed 2), each
normalized by its generator, then shuffled together by a generator of
seed 0. The loader's optional-field map zero-fills ``cell`` and
``edge_shifts`` on the gas-phase graphs, so every batch has one
structure.

    python -m hydragnn_tpu_torch.drivers.multidataset --epochs 10
    python -m hydragnn_tpu_torch.drivers.multidataset --device cpu --per_family 20 --epochs 1
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.crystals import random_crystals
from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames, reaction_path_frames


def families(n: int, reactions: bool = True):
    """The families at ``n`` a family (reaction paths: max(1, n // 10)
    paths of ten frames), in branch order."""
    out = [random_molecule_frames(n, seed=0), random_crystals(n, per_atom_energy=True, seed=1)]
    if reactions:
        out.append(reaction_path_frames(max(1, n // 10), seed=2))
    return out


def mixed_samples(fams):
    """Every family's samples with ``dataset_id`` set to its index, then
    shuffled by a generator of seed 0."""
    samples = [dataclasses.replace(s, dataset_id=fam_id)
               for fam_id, fam in enumerate(fams) for s in fam]
    np.random.default_rng(0).shuffle(samples)
    return samples


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("multidataset", "gfm_energy.json"))
    ap.add_argument("--per_family", type=int, default=150)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    fams = families(args.per_family)
    print("family sizes:", [len(f) for f in fams], "-> one encoder, 3 decoder branches")
    hist = common.train(config, common.split(mixed_samples(fams)), dev)[3]
    return dict(common.final_losses(hist), family_sizes=[len(f) for f in fams])


if __name__ == "__main__":
    main()
