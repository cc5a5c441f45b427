"""MD rollouts over trained interatomic potentials: velocity Verlet (NVE
and Langevin NVT) in K-step macros, captured as CUDA graphs on the card,
with the neighbor list and its block plan built on the device, so
every force pass runs K1 and K2, containment with a host policy ladder,
trajectory checkpoints and ``rollout`` telemetry rows.

Counterpart of ``hydragnn_tpu/simulate/``."""

from hydragnn_tpu_torch.simulate.engine import (
    RolloutEngine,
    RolloutHalt,
    RolloutResult,
    SimulationSettings,
    macro_plan,
    run_simulation,
    simulation_settings,
)
from hydragnn_tpu_torch.simulate.state import (
    MDState,
    kinetic_energy,
    maxwell_boltzmann_velocities,
    md_state_from_numpy,
    md_template_batch,
    total_momentum,
)

__all__ = [
    "MDState",
    "RolloutEngine",
    "RolloutHalt",
    "RolloutResult",
    "SimulationSettings",
    "simulation_settings",
    "macro_plan",
    "run_simulation",
    "md_template_batch",
    "md_state_from_numpy",
    "maxwell_boltzmann_velocities",
    "kinetic_energy",
    "total_momentum",
]
