"""NiNb EAM: bulk Ni-Nb alloys, total energy or energy + per-atom energies.

Counterpart of ``examples/eam/eam.py``: NiNb_EAM_bulk.json's SchNet
(graph energy head) or, with ``--multitask``, NiNb_EAM_multitask.json's
(graph energy head and a per-atom energy node head) on Ni/Nb crystals
with species-pair Lennard-Jones labels (``crystals.random_crystals``,
seed 5, per-atom energies in ``y_node`` with ``--multitask``).

    python -m hydragnn_tpu_torch.drivers.eam --multitask --epochs 10
    python -m hydragnn_tpu_torch.drivers.eam --device cpu --structures 40 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common
from hydragnn_tpu_torch.drivers.crystals import random_crystals


def eam_samples(n_structures, multitask=False):
    return random_crystals(n_structures, species=(28, 41), node_energies=multitask, seed=5)


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("eam", "NiNb_EAM_bulk.json"),
                       alt=("multitask", "graph energy + per-atom energy node head",
                            ("eam", "NiNb_EAM_multitask.json")))
    ap.add_argument("--structures", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(eam_samples(args.structures, args.multitask)),
                        dev)[3]
    out = common.final_losses(hist)
    if args.multitask:
        tasks = np.asarray(hist.test_tasks[-1]).reshape(-1)
        print(f"per-task test loss: energy {tasks[0]:.5f} atomic_energy {tasks[1]:.5f}")
        out.update(test_energy_loss=float(tasks[0]), test_atomic_energy_loss=float(tasks[1]))
    return out


if __name__ == "__main__":
    main()
