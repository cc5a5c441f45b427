"""Open DAC 2023: adsorption energies under external conditions.

Counterpart of ``examples/open_direct_air_capture_2023/train.py``:
odac23.json's SchNet (hidden 64, 3 layers, periodic) with FiLM
graph-attribute conditioning (``use_graph_attr_conditioning``) on the
OC20 driver's framework + adsorbate systems (seed 23). Each system
carries a 2-dim condition (temperature-like, coverage-like, uniform in
[-1, 1], drawn from its own generator of seed 23) as ``graph_attr``,
and its target is the z-scored energy modulated by that condition, so
it is learnable only through the conditioning input.

    python -m hydragnn_tpu_torch.drivers.odac23 --epochs 10
    python -m hydragnn_tpu_torch.drivers.odac23 --device cpu --systems 40 --epochs 2
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.oc20 import synthetic_oc20


def conditioned_samples(n_systems):
    """The OC20 slabs of seed 23, each with its condition in
    ``graph_attr`` and the condition-modulated target in ``y_graph``."""
    rng = np.random.default_rng(23)
    raw = synthetic_oc20(n_systems, seed=23)
    mu, sd = common.energy_mean_std(raw)
    samples = []
    for s in raw:
        cond = rng.uniform(-1.0, 1.0, 2).astype(np.float32)
        base = (s.energy - mu) / sd
        target = base * (1.0 + 0.6 * cond[0]) + 0.4 * cond[1]
        samples.append(dataclasses.replace(s, graph_attr=cond,
                                           y_graph=np.array([target], np.float32)))
    return samples


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("open_direct_air_capture_2023", "odac23.json"))
    ap.add_argument("--systems", type=int, default=240)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(conditioned_samples(args.systems)), dev)[3]
    print("(FiLM-conditioned)")
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
