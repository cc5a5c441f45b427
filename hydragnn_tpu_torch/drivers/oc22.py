"""Open Catalyst 2022: total energies of oxide-catalyst slabs.

Counterpart of ``examples/open_catalyst_2022/train.py``: IS2RE-style
energy prediction (no force head) with open_catalyst_energy.json's
SchNet (hidden 64, 3 layers, periodic) on the OC20 driver's slab +
adsorbate systems (seed 22), each energy z-scored over the set into
``y_graph`` (``common.normalized_energy_targets``).

    python -m hydragnn_tpu_torch.drivers.oc22 --epochs 10
    python -m hydragnn_tpu_torch.drivers.oc22 --device cpu --systems 40 --epochs 2
"""

from __future__ import annotations

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.oc20 import synthetic_oc20


def oc22_samples(n_systems):
    """The OC20 slabs of seed 22 with normalized energy targets."""
    return common.normalized_energy_targets(synthetic_oc20(n_systems, seed=22))


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0],
                       ("open_catalyst_2022", "open_catalyst_energy.json"))
    ap.add_argument("--systems", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(oc22_samples(args.systems)), dev)[3]
    return common.final_losses(hist)


if __name__ == "__main__":
    main()
