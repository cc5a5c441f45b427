"""hydragnn_tpu_torch: the PyTorch/CUDA port of ``hydragnn_tpu``.

The package mirrors the JAX package's layout (``config/``, ``data/``,
``ops/``, ``models/``, ``train/``, ``serve/``, ``utils/``,
``export.py``, ``runner.py``); each module names its JAX counterpart in
its docstring. It imports ``torch`` and numpy only — never ``jax``,
``flax``, ``optax`` or ``hydragnn_tpu`` — and keeps its own copies of
the host logic it needs (config defaulting, the synthetic data, collate,
the block planner, the packer, the request generator).

What runs today:

- training: ``run_training(config)`` then ``run_prediction(...)`` for
  SchNet, PaiNN potentials, GIN, SAGE, MFC, CGCNN, GAT and PNA/PNAPlus
  with GPS, on bucketed or bin-packed batches, with the fused edge
  pipeline's forward (K1) and backward (K2) as hand-written CUDA kernels
  on the card (``ops/edge_pipeline.py``); every run saves a checkpoint,
  from which ``run_prediction(config)`` alone predicts
  (``utils/checkpoint.py``); on the card every step is a replayed CUDA
  graph (``train/capture.py``), K steps to a graph where
  ``Parallelism.superstep`` groups them;
- serving: ``DynamicBatcher`` -> ``ServingEngine`` ->
  ``export.make_forward`` -> ``MultiHeadGraphModel``, one captured
  forward per budget on the card, the MLIP form (energies and forces)
  included; the fleet tier (``serve/fleet.ServingTier`` behind
  ``serve/router.Router``) and the load benches (``serve/loadgen.py``);
  export to a file (``export_inference``/``load_exported``, on
  ``torch.export``);
- parallel training (``parallel/``): ``Training.Parallelism`` schemes
  ``dp`` (with ZeRO/HSDP on FSDP2) and ``multibranch``, one process per
  card under ``torch.distributed``, every rank calling the same entry
  points.

- durability: the asynchronous checkpoint writer with its resume
  manifest, ``Training.continue`` with exact mid-epoch resume, and the
  divergence guard inside the (captured) train step
  (``utils/checkpoint.py``, ``train/guard.py``, ``utils/faults.py``).

- graph sharding: one structure's nodes and edges split over the ranks
  of a ``graph`` axis, all-gather or halo message passing and ring
  attention (``parallel/graphshard.py``), trained by the giant-graph
  driver (``python -m hydragnn_tpu_torch.drivers.giant_graph``).

- datasets: every format of the JAX package (raw LSMS, XYZ and CFG
  files, pickle directories, ``.hgb`` binary containers read sample by
  sample), a shared-memory sample store (``data/diststore.py``) and the
  native C++ cell list behind the radius graphs (``native.py``, built
  with ``g++`` at first use).

- MD rollouts: ``run_simulation(config, sample=..., ...)`` integrates a
  trained potential (velocity Verlet, NVE or Langevin NVT) in K-step
  macros, each one replayed CUDA graph on the card, with the on-device
  neighbor lists and block plans, the containment ladder, trajectory
  checkpoints and ``rollout`` telemetry rows (``simulate/``).

- aux utilities and example drivers: ``postprocess/`` (``output_denormalize``,
  the ``Visualizer`` that ``run_training`` drives when the config's
  ``Visualization.create_plots`` is true), ``utils/`` ``time_utils``,
  ``hpo`` (random search and an Optuna objective over ``run_training``),
  ``lsms``, ``smiles`` (the native SMILES parser) and ``descriptors``;
  the example drivers under ``drivers/``, each ``python -m
  hydragnn_tpu_torch.drivers.<name>`` with its reference script's flags
  and ``--device`` (the card by default; ``--device cpu`` is the plain
  path): ``lennard_jones``, ``md17``, ``qm9``, ``zinc``, ``csce_gap``,
  ``ogb_gap``, ``qm9_hpo``, ``lsms`` and ``giant_graph``; and the
  atomistic ones over ``drivers/crystals.py`` and ``molecules.py``:
  ``oc20``, ``oc22``, ``odac23``, ``oc25``, ``mptrj``, ``alexandria``,
  ``eam``, ``omat24``, ``ani1x``, ``nabla2_dft``, ``omol25``, ``qcml``,
  ``transition1x``, ``qm7x`` and ``qm7x_inference``; and the last nine:
  ``polymers``, ``multibranch``, ``multibranch_hpo``, ``multidataset``,
  ``multidataset_hpo``, ``sc26_hpo``, ``structure_optimization``,
  ``uv_spectrum`` and ``ising``.
- static analysis: ``analysis/``, the port's graftlint (``python -m
  hydragnn_tpu_torch.analysis --check``): config-schema, nondet,
  thread-discipline, lock-order, guarded-field, barrier-discipline and
  suppression over the port's code, with host-sync, hot-coverage and
  torch-api as the torch counterparts of the JAX package's host-sync,
  hot-coverage and jax-api.

Every module of the JAX package has its counterpart here.

Importing the package is cheap on purpose: it builds no CUDA code and
imports none of its submodules (``run_training``/``run_prediction`` load
the runner, ``export_inference``/``load_exported`` the export module,
``run_simulation`` the rollout engine, on first access). The kernels are
compiled with ``nvcc`` at their first launch (``ops/cuda_build.py``).
"""

__all__ = ["run_training", "run_prediction", "export_inference", "load_exported",
           "run_simulation"]


def __getattr__(name):
    if name in ("run_training", "run_prediction"):
        from hydragnn_tpu_torch import runner

        return getattr(runner, name)
    if name in ("export_inference", "load_exported"):
        from hydragnn_tpu_torch import export

        return getattr(export, name)
    if name == "run_simulation":
        from hydragnn_tpu_torch.simulate import engine

        return engine.run_simulation
    raise AttributeError(f"module 'hydragnn_tpu_torch' has no attribute {name!r}")
