"""Lennard-Jones interatomic potential: train, predict, and roll out.

Counterpart of ``examples/LennardJones/LennardJones.py``: LJ.json's
SchNet potential (energies and forces as the gradient of the energy)
trained on generated LJ configurations (``drivers/lj_data.py``), the
test energy and force errors reported; with ``--simulate`` the fitted
potential runs NVE velocity Verlet from a held-out configuration
through ``run_simulation`` (LJ.json's ``Simulation`` block: K steps a
macro, skin-guarded neighbor rebuilds, free boundaries).

    python -m hydragnn_tpu_torch.drivers.lennard_jones --configs 200 --simulate
    python -m hydragnn_tpu_torch.drivers.lennard_jones --device cpu --configs 40 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("LennardJones", "LJ.json"))
    ap.add_argument("--configs", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--mpnn_type", default=None)
    ap.add_argument("--simulate", action="store_true",
                    help="after training, roll the fitted potential out in time "
                    "(the Simulation block of the config)")
    ap.add_argument("--sim_steps", type=int, default=None,
                    help="override Simulation.steps for --simulate")
    args = ap.parse_args(argv)
    dev = common.device(args)

    import hydragnn_tpu_torch as port
    from hydragnn_tpu_torch.config import load_config
    from hydragnn_tpu_torch.data.loader import split_dataset
    from hydragnn_tpu_torch.drivers.lj_data import create_dataset

    config = load_config(args.config)
    if args.epochs is not None:
        config["NeuralNetwork"]["Training"]["num_epoch"] = args.epochs
    if args.mpnn_type:
        config["NeuralNetwork"]["Architecture"]["mpnn_type"] = args.mpnn_type

    samples = create_dataset(args.configs, cutoff=config["NeuralNetwork"]["Architecture"]["radius"])
    # normalize energies to a learnable scale
    es = np.array([s.energy for s in samples])
    e_mean, e_std = float(es.mean()), float(es.std() + 1e-9)
    for s in samples:
        s.energy = (s.energy - e_mean) / e_std
        s.forces = s.forces / e_std
        s.y_graph = np.array([s.energy], np.float32)
    datasets = split_dataset(samples, 0.8)

    state, model, cfg, hist, full = port.run_training(config, datasets=datasets, device=dev)
    err, tasks, trues, preds = port.run_prediction(
        full, datasets=datasets, state=state, model=model, cfg=cfg)
    e_mae = float(np.mean(np.abs(trues[0] - preds[0]))) * e_std
    f_mae = float(np.mean(np.abs(trues[1] - preds[1]))) * e_std
    print(f"Test energy MAE: {e_mae:.4f}  force MAE: {f_mae:.4f} (LJ units)")
    out = {"test_error": float(err), "energy_mae": e_mae, "force_mae": f_mae,
           "train_loss": [float(v) for v in hist.train_loss]}

    if args.simulate:
        if args.sim_steps is not None:
            config.setdefault("Simulation", {})["steps"] = args.sim_steps
        # Roll out from a held-out configuration. Free boundaries: the
        # device neighbor list is open-boundary, so the lattice
        # configuration becomes a finite LJ cluster of the fitted potential.
        start = datasets[2][0]
        res = port.run_simulation(config, sample=start, model=model, cfg=cfg, state=state,
                                  device=dev)
        sim = common.rollout_numbers(res)
        print(f"Simulation (NVE, normalized units): {sim['steps']} steps @ dt={sim['dt']}, "
              f"{sim['rebuilds']} neighbor rebuilds, energy drift {sim['energy_drift']:.3e}, "
              f"{sim['steps_per_sec']:.1f} steps/s")
        if sim["events"]:
            print(f"Simulation containment events: {sim['events']}")
        out["simulation"] = dict(sim, atoms=start.num_nodes)
    return out


if __name__ == "__main__":
    main()
