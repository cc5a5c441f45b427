"""MD17 interatomic potential: train, then optionally roll out.

Counterpart of ``examples/md17/md17.py``: md17.json's PaiNN potential
(energy and energy-conserving forces) trained on MD-trajectory-like
frames of one molecule. The MD17 download needs torch_geometric and a
network, so the frames are the reference driver's stand-in: thermal
perturbations of one 21-atom molecule with Morse-pair energies and
analytic forces (numpy draws in the reference's order, so a seed gives
its frames bit for bit). ``--simulate`` runs md17.json's own
``Simulation`` block (Langevin NVT, K = 16) from the first test frame
through ``run_simulation``.

    python -m hydragnn_tpu_torch.drivers.md17 --epochs 10 --simulate
    python -m hydragnn_tpu_torch.drivers.md17 --device cpu --frames 60 --epochs 2
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common

N_ATOMS = 21  # aspirin C9H8O4
MORSE_D, MORSE_A, MORSE_R0 = 0.5, 1.2, 1.8


def _morse_energy_forces(pos):
    """Pairwise Morse potential: E = sum D(1 - exp(-a(r - r0)))^2."""
    diff = pos[:, None, :] - pos[None, :, :]  # [n, n, 3]
    d = np.linalg.norm(diff, axis=-1)
    np.fill_diagonal(d, np.inf)
    ex = np.exp(-MORSE_A * (d - MORSE_R0))
    e_pair = MORSE_D * (1.0 - ex) ** 2
    energy = float(e_pair.sum() / 2.0)
    # dE/dr = 2 D a (1 - ex) ex ; force_i = -sum_j dE/dr * (r_i-r_j)/r
    dedr = 2.0 * MORSE_D * MORSE_A * (1.0 - ex) * ex
    with np.errstate(invalid="ignore"):
        unit = np.where(np.isfinite(d[..., None]), diff / d[..., None], 0.0)
    forces = -(dedr[..., None] * unit).sum(axis=1)
    return energy, forces.astype(np.float32)


def synthetic_md17(n_frames=400, seed=0):
    """Thermal perturbations of one fixed random molecule (an MD
    trajectory stand-in)."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    z = rng.choice([1, 6, 8], N_ATOMS, p=[0.4, 0.45, 0.15]).astype(np.float32)
    base = rng.uniform(0, 2.2 * N_ATOMS ** (1 / 3), (N_ATOMS, 3))
    out = []
    for _ in range(n_frames):
        pos = (base + rng.normal(scale=0.12, size=base.shape)).astype(np.float32)
        energy, forces = _morse_energy_forces(pos)
        out.append(GraphSample(x=z.reshape(-1, 1), pos=pos,
                               edge_index=radius_graph(pos, 4.0, max_neighbours=24),
                               energy=energy, forces=forces))
    return out


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("md17", "md17.json"))
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--mpnn_type", default=None, help="override config")
    ap.add_argument("--simulate", action="store_true",
                    help="after training, roll the fitted potential out in time (the "
                    "Simulation block of the config: Langevin NVT over the molecule)")
    ap.add_argument("--sim_steps", type=int, default=None,
                    help="override Simulation.steps for --simulate")
    args = ap.parse_args(argv)
    dev = common.device(args)

    import hydragnn_tpu_torch as port

    config = common.example_config(args)
    if args.mpnn_type:
        config["NeuralNetwork"]["Architecture"]["mpnn_type"] = args.mpnn_type

    tr, va, te = common.split(synthetic_md17(args.frames))
    state, model, cfg, hist, _ = common.train(config, (tr, va, te), dev)
    out = common.with_force_loss(hist, common.final_losses(hist))

    if args.simulate:
        if args.sim_steps is not None:
            config.setdefault("Simulation", {})["steps"] = args.sim_steps
        res = port.run_simulation(config, sample=te[0], model=model, cfg=cfg, state=state,
                                  device=dev)
        sim = common.rollout_numbers(res)
        print(f"Simulation (Langevin NVT, Morse units): {sim['steps']} steps @ "
              f"dt={sim['dt']}, {sim['rebuilds']} neighbor rebuilds, "
              f"{sim['steps_per_sec']:.1f} steps/s")
        if sim["events"]:
            print(f"Simulation containment events: {sim['events']}")
        out["simulation"] = dict(sim, atoms=te[0].num_nodes)
    return out


if __name__ == "__main__":
    main()
