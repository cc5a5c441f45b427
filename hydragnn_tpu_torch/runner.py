"""End-to-end orchestration: ``run_training`` and ``run_prediction``.

Counterpart of ``hydragnn_tpu/runner.py``: config loading, raw ingestion
and splitting, ``update_config``, model and optimizer construction, the
epoch loop, and a test pass that collects per-sample predictions. Both
entry points run on the rank's card (``cuda:LOCAL_RANK``) unless the
caller passes another ``device`` (the tests pass ``"cpu"``).

Parallelism (``Training.Parallelism``, ``parallel/runtime.py``): every
rank of the default process group calls the same entry point
(``torchrun --nproc_per_node N``, or the ``HYDRAGNN_TPU_*`` rendezvous
variables, which ``maybe_initialize_distributed`` reads). ``scheme``
``"single"`` trains one device; ``"dp"`` (with ``data``, ``fsdp``,
``zero``; what ``"auto"`` resolves to when the world holds more than
one rank) gives every rank the same datasets and seed, the same
coordinated epoch plan (device-coordinated packing, or the cross-rank
spec schedules) and its own slot of each step (``parallel/dp.py``:
the graph-weighted gradient sum, FSDP2 sharding under ``zero``/``fsdp``);
``"multibranch"`` takes ``datasets`` as per-branch (train, val, test)
triples and trains one shared encoder with per-branch decoders
(``parallel/multibranch.py``). Under several nodes each node gets its
equal shard of the data (the JAX package's multi-host form). Each
rank's step is the single scheme's with the collectives added, so K1/K2
run inside every rank's step (the segment plan is attached under every
scheme, where the JAX package attaches it on the single scheme only: its
planned ``pallas_call`` does not run under the dp step's ``vmap``).

Bin packing (``Training.Parallelism.packing``) is resolved as the JAX
package resolves it on the single scheme: ``"auto"`` (the default)
packs when the fitted budgets beat the unpacked ladder's padding waste
(``padschedule.packing_beats_ladder`` on the train split's sizes and the
run's seed), ``true`` fits budgets, and eval loaders fit their own
budgets with the train-tuned slack. Models whose batches carry angular
triplets (``models/create.needs_triplets``: DimeNet) never pack, as in
the JAX package: ``"auto"`` falls back to unpacked batches quietly, an
explicit request with a message; their loaders keep the one worst-case
shape (``GraphLoader(with_triplets=True)``).

Supersteps (``Training.Parallelism.superstep``) are resolved as the JAX
runner resolves them on the single scheme (``parallel/runtime.py``: an
integer pins K, ``"auto"`` asks the epoch plan), and a loader with K > 1
delivers K-batch groups (``data/loader.SuperstepLoader``, or the
pipeline's own groups).

The input feed (``Training.Parallelism.pipeline`` and ``prefetch``) is
resolved and wrapped as the JAX runner does it
(``parallel/runtime.wrap_loader``): collation workers where
``pipeline.workers`` > 0 (by default ``min(4, cpus - 2)`` on a host of 4
or more CPUs), else the prefetch thread; the run logs the feed at
verbosity 2. The multibranch scheme ignores ``pipeline.workers``, with
the JAX package's message, and prefetches its three loaders. The
workers and the prefetch thread hand host batches to the loop, which
makes the one copy to the card. On the card
every train, eval and test step runs through the run's CUDA-graph cache
(``train/capture.StepGraphs``, kept on the returned state), as the JAX
package runs every step through ``jax.jit``; a capture that fails
raises.

Checkpoints: every run saves through its ``CheckpointWriter``
(``utils/checkpoint.py``, asynchronous unless ``Checkpoint.async`` is
false; closed before ``run_training`` returns) under
``./logs/<log_name>/``: its final state, and with ``Training.Checkpoint``
every improving epoch and every ``interval_steps`` steps, each save with
the resume manifest. ``run_prediction(config)`` given no state restores
the run's ``latest`` checkpoint (``restore_checkpoint_state``).
``Training.continue`` restores the newest resume container of the run
(``find_continue_log_name``: the derived name, the caller's in-flight
run, or a sibling differing in ``num_epoch`` whose fingerprint matches)
and continues at its cursor, bit for bit; a container written under
another config fingerprint or plan seed, a multibranch container whose
per-branch cursors disagree with its step, or a checkpoint without a
manifest, restarts from epoch 0 with the restored weights, loudly.
``Training.checkpoint_format: "orbax"`` writes and reads the sharded
format instead (``utils/checkpoint.py``: each rank its own shards, no
gather), in every save, ``continue`` and ``run_prediction(config)``.
``Training.Guard`` turns on the divergence guard (``train/guard.py``;
per branch under the multibranch scheme).
``Training.Telemetry`` opens the run's telemetry stream
(``utils/telemetry.py``: ``logs/<log_name>/telemetry.jsonl``, one shard
per rank), configured once the model is on its device so the header
names the card and its peaks, and closed also on the error path;
``Training.Profiling`` opens a ``torch.profiler`` window over one epoch
(``utils/tracer.Profiler``); ``HYDRAGNN_TPU_TRACE_LEVEL`` > 0 installs
the region timer and device counters, whose CSV lands in the run's
directory.
``Training.bn_recalibration`` refreshes the running statistics at the
end of training from an eval-shaped, unpacked loader over the train
split.
The config's ``Visualization`` section (``create_plots``; the
``error_histograms``, ``global_analysis`` and ``task_history`` switches)
draws the JAX runner's end-of-run plots at world 1, after the telemetry
stream is closed: a per-sample test pass through the run's graph cache,
then ``postprocess.Visualizer``'s plots under ``logs/<log_name>/``.

Datasets (``_ingest_datasets``): every format the JAX package reads, the
raw LSMS, CFG and XYZ files, pickle directories and binary containers;
a container is read sample by sample as batches need it, never
materialized (``data/loader.GraphLoader``). Every loader of a run
zero-fills the optional fields of one map over the full splits
(``graph.optional_field_widths_multi``), so all its batches have one
structure, and a dataset whose label or position fields are present on
some samples only is refused. An interatomic-potential config
(``enable_interatomic_potential``) trains on the energy + force loss,
and ``run_prediction`` then returns graph energies and forces.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hydragnn_tpu_torch.config import load_config, save_config, update_config
from hydragnn_tpu_torch.data.graph import (
    GraphSample,
    PadSpec,
    bucket_size,
    count_triplets,
    optional_field_widths,
    optional_field_widths_multi,
    select_input_features,
)
from hydragnn_tpu_torch.data.loader import GraphLoader, split_dataset
from hydragnn_tpu_torch.data.padschedule import (
    dataset_size_arrays,
    dp_packing_beats_schedule,
    dp_spec_schedule,
    fit_pack_budgets,
    packing_beats_ladder,
    worst_case_spec_from_sizes,
)
from hydragnn_tpu_torch.data.prefetch import PrefetchLoader
from hydragnn_tpu_torch.data.raw import RawSample, process_raw_samples, read_lsms_directory
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.create import create_model_config, needs_triplets
from hydragnn_tpu_torch.parallel import runtime
from hydragnn_tpu_torch.parallel.dp import capturable, eager_reason
from hydragnn_tpu_torch.parallel.multibranch import (
    MultiBranchLoader,
    dual_optimizer,
    proportional_branch_split,
)
from hydragnn_tpu_torch.parallel.runtime import resolve_superstep_k
from hydragnn_tpu_torch.train.capture import StepGraphs
from hydragnn_tpu_torch.train.loop import bn_recalibration_epochs, train_validate_test
from hydragnn_tpu_torch.train.loop import test as run_test
from hydragnn_tpu_torch.train.optimizer import grad_clip_norm, select_optimizer
from hydragnn_tpu_torch.train.state import TrainState, resolve_precision
from hydragnn_tpu_torch.utils.checkpoint import (
    CheckpointWriter,
    checkpoint_format,
    checkpoint_settings,
    config_fingerprint,
    find_continue_log_name,
    load_checkpoint,
    load_resume_checkpoint,
)
from hydragnn_tpu_torch.utils import telemetry
from hydragnn_tpu_torch.utils import tracer as tr
from hydragnn_tpu_torch.utils.print_utils import (
    get_log_name_config,
    print_distributed,
    setup_log,
)


def _ingest_datasets(config: dict) -> Tuple[Sequence[GraphSample], ...]:
    """train/val/test datasets per the ``Dataset`` section, as the JAX
    package reads them. ``unit_test``/``LSMS``, ``CFG`` and ``XYZ`` read
    raw files (one ``total`` directory split by ``perc_train``, or one per
    split; normalization statistics come from all of them; CFG/XYZ take
    ``node_features``/``graph_features`` column selections and need a
    graph-target sidecar when the config asks for a graph output).
    ``pickle`` opens a ``SimplePickleDataset`` per split and
    ``binary``/``hgb``/``adios`` a ``BinDataset`` per split file
    (``Dataset.preload`` reads it into memory up front; otherwise every
    sample is read from the file when a batch needs it); both are stored
    with their full node features, so ``input_node_features`` is applied
    here. Any other format raises ValueError."""
    ds = config.get("Dataset", {})
    fmt = ds.get("format", "unit_test")
    paths = ds.get("path", {})
    training = config["NeuralNetwork"]["Training"]
    perc_train = float(training.get("perc_train", 0.7))
    stratified = bool(ds.get("compositional_stratified_splitting", False))

    def _ingest_raw(reader):
        if not isinstance(paths, dict):
            raise ValueError(f"Dataset.path must be a dict, got {type(paths)}")
        if "total" in paths:
            samples = process_raw_samples(reader(paths["total"]), config)
            return split_dataset(samples, perc_train, stratified=stratified)
        raws = {split: reader(paths[split]) for split in ("train", "validate", "test")}
        samples = process_raw_samples(raws["train"] + raws["validate"] + raws["test"], config)
        n_tr, n_va = len(raws["train"]), len(raws["validate"])
        return samples[:n_tr], samples[n_tr : n_tr + n_va], samples[n_tr + n_va :]

    if fmt in ("unit_test", "LSMS"):
        return _ingest_raw(lambda p: read_lsms_directory(p, ds))
    if fmt in ("CFG", "XYZ"):
        from hydragnn_tpu_torch.data.formats import read_cfg_directory, read_xyz_directory

        reader = read_cfg_directory if fmt == "CFG" else read_xyz_directory
        node_cols = ds.get("node_features", {}).get("column_index")
        graph_cols = ds.get("graph_features", {}).get("column_index")
        wants_graph_target = "graph" in config["NeuralNetwork"][
            "Variables_of_interest"].get("type", [])

        def _to_raw(p):
            out = []
            for s in reader(p):
                if s.y_graph is None and wants_graph_target:
                    raise ValueError(
                        f"{fmt} sample in {p} has no graph target sidecar "
                        "(_energy.txt / .bulk) but the config asks for a graph output"
                    )
                x = np.asarray(s.x, np.float64)
                if node_cols is not None:
                    x = x[:, node_cols]
                y = (np.asarray(s.y_graph, np.float64) if s.y_graph is not None
                     else np.zeros(1))
                if graph_cols is not None and s.y_graph is not None:
                    y = y[graph_cols]
                out.append(RawSample(node_features=x, positions=np.asarray(s.pos, np.float64),
                                     graph_features=y, cell=s.cell))
            return out

        return _ingest_raw(_to_raw)
    in_cols = _input_cols(config)
    if fmt == "pickle":
        from hydragnn_tpu_torch.data.pickledataset import SimplePickleDataset

        return tuple(select_input_features(SimplePickleDataset(paths[split]), in_cols)
                     for split in ("train", "validate", "test"))
    if fmt in ("binary", "hgb", "adios"):
        from hydragnn_tpu_torch.data.binformat import BinDataset

        if not isinstance(paths, dict) or not all(
            k in paths for k in ("train", "validate", "test")
        ):
            raise ValueError(
                "binary format needs Dataset.path with train/validate/test container "
                f"files (write splits separately with write_bin_dataset); got {paths!r}"
            )
        preload = bool(ds.get("preload", False))
        return tuple(
            select_input_features(BinDataset(paths[split], preload=preload), in_cols)
            for split in ("train", "validate", "test"))
    raise ValueError(f"Unknown Dataset.format: {fmt}")


def _input_cols(config: dict):
    return config.get("NeuralNetwork", {}).get("Variables_of_interest", {}).get(
        "input_node_features"
    )


def _check_num_nodes_bound(config: dict, *datasets) -> None:
    """Raise when a graph exceeds ``Architecture.num_nodes``, the static
    per-graph bound of GPS's dense layout and of per-node heads (the
    dense scatter would drop its extra nodes)."""
    arch = config["NeuralNetwork"]["Architecture"]
    heads = arch.get("output_heads", {})
    needs_bound = bool(arch.get("global_attn_engine")) or (
        isinstance(heads.get("node"), dict)
        and heads["node"].get("type") == "mlp_per_node"
    )
    bound = arch.get("num_nodes")
    if not needs_bound or bound is None:
        return
    max_n = max((int(dataset_size_arrays(ds)[0].max()) for ds in datasets if len(ds)),
                default=0)
    if max_n > int(bound):
        raise ValueError(
            f"Graph with {max_n} nodes exceeds Architecture.num_nodes="
            f"{bound}; raise num_nodes (it must bound every split)"
        )


def _resume(config: dict, log_name: str, state: TrainState, seed: int, multibranch: bool,
            verbosity: int) -> Optional[dict]:
    """``Training.continue``: restore the run's newest durable state into
    ``state`` and return its manifest, or None where the cursor does not
    hold (module docstring)."""
    fmt = checkpoint_format(config["NeuralNetwork"]["Training"])
    state, manifest = load_resume_checkpoint(log_name, state, fmt=fmt)
    if manifest is None:
        print_distributed(verbosity, 0, f"continue: '{log_name}' holds a checkpoint without a "
                          "resume manifest; restarting from epoch 0 with its weights")
        return None
    mf, ms = manifest.get("config_fingerprint"), manifest.get("plan_seed")
    fingerprint = config_fingerprint(config)
    if (mf is not None and mf != fingerprint) or (ms is not None and int(ms) != int(seed)):
        print_distributed(
            verbosity, 0,
            "resume manifest ignored: config fingerprint or plan seed changed since the "
            f"checkpoint (saved {mf}/{ms}, now {fingerprint}/{seed}) — the (epoch, step) "
            "cursor no longer addresses the same batch sequence; restarting from epoch 0 "
            "with the restored weights")
        return None
    bs, step = manifest.get("branch_steps"), int(manifest.get("step", 0))
    if multibranch and bs is not None and any(int(b) != step for b in bs):
        print_distributed(
            verbosity, 0,
            f"resume manifest ignored: per-branch cursors {bs} disagree with the global step "
            f"{step} — the multibranch feed consumes branches in lockstep and cannot honor a "
            "drifted container; restarting from epoch 0 with the restored weights")
        return None
    return manifest


def packing_settings(config: dict) -> dict:
    """The ``Training.Parallelism.packing`` block resolved with the JAX
    package's strict grammar (``parallel/runtime._packing_from_config``,
    its environment overrides included): ``enabled`` is ``"auto"`` (the
    default), ``True`` or ``False``, plus ``max_budgets``, ``slack`` and
    ``max_graphs``."""
    par = config["NeuralNetwork"].get("Training", {}).get("Parallelism", {})
    pk = runtime._packing_from_config(par)
    return {"enabled": pk["packing"], "max_budgets": pk["packing_max_budgets"],
            "slack": pk["packing_slack"], "max_graphs": pk["packing_max_graphs"]}


def resolve_packing(pk: dict, batch_size: int, trainset, seed: int = 0, *,
                    trips: bool = False, verbosity: int = 0, n_shards: int = 0,
                    multinode: bool = False) -> tuple:
    """``(packing_on, train_budgets, slack)``, as the JAX runner's
    ``_resolve_packing`` decides: ``"auto"`` packs when
    ``packing_beats_ladder`` (or, for a dp run over ``n_shards`` > 1
    slots, ``dp_packing_beats_schedule``, which packs device-coordinated)
    finds the fitted budgets beat the run's unpacked baseline on the
    train split's sizes and ``seed``; ``True`` fits the budgets. The
    slack is the train fit's, which the eval loaders reuse. A
    triplet-bearing model (``trips``), an empty train split, fewer
    graphs than slots, or a dp run across nodes (``multinode``: the
    nodes' shards would pack different plans) never packs; an explicit
    request then says why."""
    mode = pk["enabled"]
    if not mode:
        return False, None, None
    blocked = None
    if multinode:
        blocked = ("multi-node dp shards would pack divergent per-node plans; the "
                   "cross-node spec schedules coordinate shapes there")
    elif trips:
        blocked = "packing budgets do not cover triplet counts"
    elif not len(trainset):
        blocked = "empty training set"
    elif n_shards > 1 and len(trainset) < n_shards:
        blocked = (f"{len(trainset)} training graphs cannot feed {n_shards} devices a "
                   "coordinated packed plan")
    if blocked:
        if mode != "auto":
            print_distributed(
                verbosity, 0, f"Training.Parallelism.packing ignored: {blocked}"
            )
        return False, None, None
    ns, es = dataset_size_arrays(trainset)
    kw = dict(max_budgets=pk["max_budgets"], slack=pk["slack"],
              max_graphs=pk["max_graphs"], seed=int(seed))
    if mode == "auto":
        if n_shards > 1:
            won = dp_packing_beats_schedule(ns, es, batch_size, n_shards, **kw)
        else:
            won = packing_beats_ladder(ns, es, batch_size, **kw)
        return (False, None, None) if won is None else (True, won[0], won[1])
    if pk["slack"] is not None:
        return True, fit_pack_budgets(ns, es, batch_size, **kw), pk["slack"]
    budgets, meta = fit_pack_budgets(ns, es, batch_size, with_meta=True, **kw)
    return True, budgets, meta["slack"]


def _dp_pad_schedules(plan, batch_size: int, seed: int, trips: bool, datasets) -> tuple:
    """Per-split spec schedules of an unpacked dp run (train, val,
    test), or three None for the fixed worst-case spec: built from the
    FULL datasets so every rank computes the same per-step specs; taken
    when the train schedule's ladder stays within the bucket limit (the
    JAX package's ``_dp_pad_schedules`` in its default "auto" mode).
    Triplet-bearing models keep the worst case."""
    fixed = (None, None, None)
    if trips:
        return fixed
    n_procs = runtime.process_count()
    n_local = max(plan.data_parallel_size // n_procs, 1)

    def _sched(ds, shuffle, sched_seed):
        ns, es = dataset_size_arrays(ds)
        return dp_spec_schedule(ns, es, batch_size=batch_size, n_procs=n_procs,
                                steps_group=n_local, seed=sched_seed, shuffle=shuffle)

    trainset, valset, testset = datasets
    cand = _sched(trainset, True, seed)
    if not cand.ladder_is_small():
        return fixed
    return cand, _sched(valset, False, 0), _sched(testset, False, 0)


def _pin_full_worst_specs(loaders_and_datasets, batch_size: int, trips: bool) -> None:
    """Across nodes, pad every node's fixed-shape batches to the worst
    case of the FULL dataset (not of its shard), so the ranks' steps
    agree."""
    for loader, full in loaders_and_datasets:
        spec = worst_case_spec_from_sizes(*dataset_size_arrays(full), batch_size)
        if trips:
            t_sizes = sorted((count_triplets(s) for s in full), reverse=True)
            spec = PadSpec(num_nodes=spec.num_nodes, num_edges=spec.num_edges,
                           num_graphs=spec.num_graphs,
                           num_triplets=bucket_size(max(sum(t_sizes[:batch_size]), 1)))
        loader.pad_spec = spec


def _branch_sets(config: dict, datasets) -> list:
    """The multibranch scheme's per-branch (train, val, test) lists."""
    if datasets is None or not all(
        isinstance(d, (tuple, list)) and len(d) == 3 for d in datasets
    ):
        raise ValueError(
            "multibranch scheme needs datasets=[(train,val,test), ...] per branch"
        )
    in_cols = _input_cols(config)
    return [tuple(select_input_features(list(x), in_cols) for x in d) for d in datasets]


def _devices_per_branch(plan, branch_sets) -> List[int]:
    """Slots per branch: proportional to the train splits' sizes, or
    uniform with ``HYDRAGNN_TPU_TASK_PARALLEL_PROPORTIONAL_SPLIT=0``."""
    d = plan.data_parallel_size
    if os.environ.get("HYDRAGNN_TPU_TASK_PARALLEL_PROPORTIONAL_SPLIT", "1") in ("0", "false"):
        k = len(branch_sets)
        if d < k:
            raise ValueError(f"{d} devices < {k} branches")
        base, rem = divmod(d, k)
        return [base + (1 if i < rem else 0) for i in range(k)]
    return proportional_branch_split([len(b[0]) for b in branch_sets], d)


def _step_graphs(dev: torch.device) -> Optional[StepGraphs]:
    """The run's CUDA-graph cache on a card; None on the CPU."""
    return StepGraphs(dev) if dev.type == "cuda" else None


def _dp_loaders(config, plan, datasets, batch_size, seed, trips, seg_plan, verbosity, dev):
    """The dp scheme's (train, val, test) loaders, wrapped to this
    rank's slot and fed for the plan on ``dev``
    (``runtime.wrap_loader``): as the JAX runner forms them (the node's shards;
    device-coordinated packing where ``resolve_packing`` says so, with a
    per-split fallback when a split cannot feed every slot; else the
    cross-rank spec schedules or the worst case)."""
    trainset, valset, testset = datasets
    # one map over the full splits: per-shard maps could differ by node
    ensure = optional_field_widths_multi(datasets)
    splits = tuple(runtime.shard_dataset_for_process(d) for d in datasets)
    multinode = runtime.process_count() > 1
    pk = packing_settings(config)
    packed, budgets, slack = resolve_packing(
        pk, batch_size, splits[0], seed, trips=trips, verbosity=verbosity,
        n_shards=plan.data_parallel_size, multinode=multinode)
    scheds: list = []

    def _build(which, ds, pack):
        sched = None
        if not pack:
            if not scheds:
                scheds.append(_dp_pad_schedules(plan, batch_size, seed, trips, datasets))
            sched = scheds[0][which]
        kw = dict(with_triplets=trips, with_segment_plan=seg_plan, fixed_pad=True,
                  ensure_fields=ensure, spec_schedule=sched, packing=pack,
                  pack_max_budgets=pk["max_budgets"],
                  pack_slack=pk["slack"] if pk["slack"] is not None else slack,
                  pack_max_graphs=pk["max_graphs"],
                  pack_dp_shards=plan.data_parallel_size if pack else 0)
        if which == 0:
            return GraphLoader(ds, batch_size, shuffle=True, seed=seed,
                               pack_budgets=budgets if pack else None, **kw)
        # a fixed-order eval loader keeps its batches for later epochs,
        # over in-memory lists only: a lazy container keeps its footprint
        return GraphLoader(ds, batch_size, cache_batches=isinstance(ds, (list, tuple)), **kw)

    loaders = [_build(i, ds, packed) for i, ds in enumerate(splits)]
    if packed:
        print_distributed(
            verbosity, 2, "packing: on (device-coordinated), train budgets "
            f"{[(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]}")
        for i, ds in enumerate(splits):
            try:
                len(loaders[i])
            except ValueError as e:
                print_distributed(verbosity, 0, "Training.Parallelism.packing disabled "
                                  f"for the {('train', 'val', 'test')[i]} split: {e}")
                loaders[i] = _build(i, ds, False)
    if multinode and not (scheds and scheds[0][0] is not None):
        _pin_full_worst_specs(list(zip(loaders, datasets)), batch_size, trips)
    return tuple(runtime.wrap_loader(plan, ld, device=dev) for ld in loaders)


def _single_loaders(config, plan, training, datasets, batch_size, seed, trips, seg_plan,
                    verbosity, dev):
    """The single scheme's (train, val, test) loaders, fed for the plan
    on ``dev`` (``runtime.wrap_loader``: superstep groups where K > 1),
    and the batch-norm recalibration feed (None when
    ``Training.bn_recalibration`` is off)."""
    trainset, valset, testset = datasets
    pk = packing_settings(config)
    packed, budgets, slack = resolve_packing(pk, batch_size, trainset, seed,
                                             trips=trips, verbosity=verbosity)
    pack_kw = dict(packing=packed, pack_max_budgets=pk["max_budgets"],
                   pack_slack=slack, pack_max_graphs=pk["max_graphs"])
    ensure = optional_field_widths_multi(datasets)
    if packed:
        print_distributed(
            verbosity, 2,
            "packing: on, train budgets "
            f"{[(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]}",
        )
    train_loader = GraphLoader(
        trainset, batch_size, shuffle=True, seed=seed, fixed_pad="auto",
        with_triplets=trips, with_segment_plan=seg_plan, pack_budgets=budgets,
        ensure_fields=ensure, **pack_kw,
    )
    val_loader, test_loader = (
        GraphLoader(ds, batch_size, fixed_pad="auto", with_triplets=trips,
                    with_segment_plan=seg_plan, ensure_fields=ensure,
                    cache_batches=isinstance(ds, (list, tuple)), **pack_kw)
        for ds in (valset, testset)
    )
    # The recalibration reads plain unpacked batches of the train split,
    # as eval batches them (the JAX runner's recal_loader).
    recal_loader = (
        GraphLoader(trainset, batch_size, with_triplets=trips, with_segment_plan=seg_plan,
                    ensure_fields=ensure)
        if bn_recalibration_epochs(training) else None
    )
    k = resolve_superstep_k(plan, train_loader)
    if k > 1:
        print_distributed(verbosity, 2, f"supersteps: K = {k}")
    train_loader, val_loader, test_loader = (
        runtime.wrap_loader(plan, ld, device=dev)
        for ld in (train_loader, val_loader, test_loader))
    return train_loader, val_loader, test_loader, recal_loader


def _multibranch_loaders(plan, branch_sets, batch_size, seed, trips, seg_plan, verbosity):
    """The multibranch scheme's (train, val, test) ``MultiBranchLoader``s
    over this rank's slot (variable padding "auto", as the JAX runner's
    default; triplet-bearing models keep the worst case), each behind
    the prefetch thread where ``plan.prefetch`` > 0. The collation
    workers drive one GraphLoader's plan; a ``MultiBranchLoader`` owns
    its slot loaders, so ``pipeline.workers`` is ignored, as in the JAX
    package."""
    if plan.pipeline_workers > 0:
        print_distributed(verbosity, 2, "input pipeline: multibranch scheme uses the "
                          "single-thread prefetch feed (pipeline.workers ignored)")
    dpb = plan.devices_per_branch
    slot = plan.mesh.slot()
    loaders = (
        MultiBranchLoader([d[i] for d in branch_sets], dpb, batch_size, slot,
                          shuffle=i == 0, seed=seed, with_triplets=trips,
                          variable_pad=False if trips else "auto",
                          with_segment_plan=seg_plan)
        for i in range(3)
    )
    return tuple(PrefetchLoader(ld, depth=plan.prefetch) if plan.prefetch > 0 else ld
                 for ld in loaders)


def _plan_for_world(config: dict):
    """The run's ``ParallelPlan``, checked against the world: a dp or
    multibranch mesh uses every rank."""
    plan = runtime.plan_from_config(config)
    if plan.mesh is not None and plan.mesh.size != runtime.world_size():
        raise ValueError(
            f"Parallelism {plan.mesh.shape} needs {plan.mesh.size} ranks; the world "
            f"holds {runtime.world_size()} (launch one rank per device slot)"
        )
    return plan


def _run_state(plan, model, optimizer, dev) -> TrainState:
    """A ``TrainState`` with the run's graph cache where the plan's steps
    can be captured (``parallel/dp.capturable``), else none and the
    reason."""
    if capturable(plan):
        return TrainState(model, optimizer, graphs=_step_graphs(dev))
    return TrainState(model, optimizer, eager_reason=eager_reason(plan))


def run_training(
    config_source,
    datasets: Optional[Tuple[Sequence[GraphSample], ...]] = None,
    *,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
):
    """Train end to end from a JSON config (path or dict) on this rank's
    device (``None`` means ``cuda:LOCAL_RANK``). ``datasets`` may give
    (train, val, test) sample lists instead of ``Dataset.path`` (under
    the multibranch scheme: one such triple per branch). Every rank of a
    dp or multibranch run calls this together (module docstring). Every
    batch carries the block plan at the Hopper tiles unless
    ``Training.use_segment_plan`` is false, so each aggregation runs K1
    forward and K2 backward; batches are bin-packed where
    ``resolve_packing`` says so, and grouped into supersteps where
    ``Parallelism.superstep`` resolves to K > 1. On the card every step
    replays a captured CUDA graph (``state.graphs``), except where the
    plan's steps cannot be captured (``state.eager_reason``).

    Returns (state, model, cfg, history, config)."""
    config = load_config(config_source)
    runtime.maybe_initialize_distributed()
    dev = resolve_device(device)
    verbosity = int(config.get("Verbosity", {}).get("level", 0))
    plan = _plan_for_world(config)
    multibranch = plan.scheme == "multibranch"
    branch_sets = None
    if multibranch:
        branch_sets = _branch_sets(config, datasets)
        trainset, valset, testset = ([s for b in branch_sets for s in b[i]] for i in range(3))
    elif datasets is None:
        trainset, valset, testset = _ingest_datasets(config)
    else:
        in_cols = _input_cols(config)
        trainset, valset, testset = (select_input_features(d, in_cols) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    _check_num_nodes_bound(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    log_name = get_log_name_config(config)
    if training.get("continue"):
        log_name = find_continue_log_name(log_name, preferred=config.get("_log_name"),
                                          fingerprint=config_fingerprint(config))
    if verbosity > 0:
        setup_log(log_name)
    if runtime.rank() == 0:
        save_config(config, log_name)
    config["_log_name"] = log_name
    trace_env = os.environ.get("HYDRAGNN_TPU_TRACE_LEVEL", "").strip()
    if trace_env.isdigit() and int(trace_env) > 0 and not tr.has("RegionTimer"):
        tr.initialize(["RegionTimer", "DeviceMetricsTracer"])

    param_dtype, compute_dtype = resolve_precision(training.get("precision", "fp32"), dev)
    batch_size = int(training.get("batch_size", 32))
    seg_plan = training.get("use_segment_plan", True)
    seg_plan = True if seg_plan == "auto" else bool(seg_plan)
    model, cfg = create_model_config(config, dev, seed=seed)
    model.to(param_dtype)
    print_distributed(
        verbosity, 1, f"Model parameters: {sum(p.numel() for p in model.parameters())}"
    )
    trips = needs_triplets(cfg.mpnn_type)
    recal_loader = None
    if multibranch:
        plan = dataclasses.replace(
            plan, devices_per_branch=tuple(_devices_per_branch(plan, branch_sets)))
        print_distributed(verbosity, 2, f"multibranch: devices per branch "
                          f"{list(plan.devices_per_branch)}")
        train_loader, val_loader, test_loader = _multibranch_loaders(
            plan, branch_sets, batch_size, seed, trips, seg_plan, verbosity)
    elif plan.scheme == "dp":
        print_distributed(verbosity, 2, f"dp: mesh {plan.mesh.shape}, "
                          f"{'FSDP2 ' + plan.fsdp_axis if plan.fsdp else 'replicated'}")
        train_loader, val_loader, test_loader = _dp_loaders(
            config, plan, (trainset, valset, testset), batch_size, seed, trips, seg_plan,
            verbosity, dev)
    else:
        train_loader, val_loader, test_loader, recal_loader = _single_loaders(
            config, plan, training, (trainset, valset, testset), batch_size, seed, trips,
            seg_plan, verbosity, dev)
    if not multibranch:
        print_distributed(verbosity, 2, runtime.feed_line(plan))
    model = runtime.prepare_state(plan, model, dev)
    optimizer = (dual_optimizer(model, training) if multibranch
                 else select_optimizer(model.parameters(), training))
    state = _run_state(plan, model, optimizer, dev)
    if state.eager_reason:
        print_distributed(verbosity, 1, f"steps run eagerly: {state.eager_reason}")
    manifest = (_resume(config, log_name, state, seed, multibranch, verbosity)
                if training.get("continue") else None)
    ckpt = checkpoint_settings(training)
    writer = CheckpointWriter(
        log_name, keep=int(training.get("checkpoint_keep", 5)), retries=ckpt.retries,
        backoff_s=ckpt.backoff_s, async_enabled=ckpt.async_enabled, plan_seed=int(seed),
        fingerprint=config_fingerprint(config), validate_finite=ckpt.validate_finite,
        fmt=checkpoint_format(training))
    # Configured here, with the model on its device (the header names the
    # card), right before the try whose finally closes it.
    tel_stream = telemetry.configure(training, log_name=log_name, device=dev,
                                     meta={"log_name": log_name, "scheme": plan.scheme})
    if tel_stream is not None:
        telemetry.set_context(model_cfg=cfg, scheme=plan.scheme, epoch=0)
        telemetry.emit_memory("run_start")
    done = False
    try:
        state, hist = train_validate_test(
            model, cfg, state, train_loader, val_loader, test_loader, config,
            device=dev, compute_dtype=compute_dtype,
            clip_norm=grad_clip_norm(training), verbosity=verbosity,
            writer=writer, resume=manifest, recal_loader=recal_loader,
            plan=None if plan.scheme == "single" else plan,
        )
        done = True
    finally:
        # every rank meets the others once the final save is durable; a
        # rank leaving on an error does not wait for ranks it left behind
        writer.close(barrier=done)
        tr.close_window()
        telemetry.close_run(tel_stream)
    if config.get("Visualization", {}).get("create_plots", False) and runtime.world_size() == 1:
        _create_plots(config, log_name, state, model, cfg, hist,
                      (trainset, valset, testset), dev=dev, compute_dtype=compute_dtype,
                      batch_size=batch_size, trips=trips, seg_plan=seg_plan)
    if tr.has("RegionTimer"):
        tr.save(log_name)
    return state, model, cfg, hist, config


def _create_plots(config, log_name, state, model, cfg, hist, datasets, *, dev, compute_dtype,
                  batch_size, trips, seg_plan) -> None:
    """The end-of-run plots of the config's ``Visualization`` section
    (the JAX runner's hook): a per-sample test pass, as ``run_prediction``
    makes it, through the run's graph cache, then ``Visualizer``'s seven
    plots under ``logs/<log_name>/``. It runs after the telemetry stream
    is closed, so the pass's shapes never read as retrace leaks. Without
    matplotlib the import raises."""
    from hydragnn_tpu_torch.postprocess import Visualizer

    trainset, valset, testset = datasets
    loader = GraphLoader(testset, batch_size, with_triplets=trips, with_segment_plan=seg_plan)
    _, _, trues, preds = run_test(
        model, cfg, _prediction_state(state, None, dev), loader, device=dev,
        compute_dtype=compute_dtype, compute_grad_energy=cfg.enable_interatomic_potential)
    if cfg.enable_interatomic_potential:
        names = ["energy", "forces"]  # run_test's MLIP collections
    else:
        names = [h.name for h in cfg.heads]
    viz = Visualizer(log_name, num_heads=len(names))
    viz.create_scatter_plots(trues, preds, output_names=names)
    viz.plot_history(hist.train_loss, hist.val_loss, hist.test_loss)
    viz.num_nodes_plot([trainset, valset, testset], ["train", "val", "test"])
    vcfg = config.get("Visualization", {})
    if vcfg.get("error_histograms", True):
        viz.create_error_histograms(trues, preds, output_names=names)
    if vcfg.get("global_analysis", True):
        viz.create_plot_global(trues, preds, output_names=names)
    if vcfg.get("task_history", True):
        viz.plot_task_history(hist.train_tasks, task_names=names)
    if cfg.enable_interatomic_potential and trues[1].ndim == 2:
        viz.create_parity_plot_vector(trues[1], preds[1], name="forces")


def restore_checkpoint_state(config: dict, model) -> TrainState:
    """A ``TrainState`` for ``model`` with the optimizer ``Training``
    names (the dual optimizer under the multibranch scheme), loaded from
    the run's ``latest`` checkpoint (or its newest restorable epoch
    file), in ``Training.checkpoint_format``'s format (the sharded one
    assembled whole where the model is not sharded as it was). A config
    that came back from ``run_training`` names its run
    directory (``_log_name``); a fresh one derives it, and when that
    directory holds no checkpoint (``num_epoch`` changed since
    training), ``find_continue_log_name`` finds the run that does."""
    training = config["NeuralNetwork"]["Training"]
    if training.get("Parallelism", {}).get("scheme") == "multibranch":
        optimizer = dual_optimizer(model, training)
    else:
        optimizer = select_optimizer(model.parameters(), training)
    state = TrainState(model, optimizer)
    log_name = config.get("_log_name") or find_continue_log_name(
        get_log_name_config(config)
    )
    return load_checkpoint(log_name, state, fmt=checkpoint_format(training))


def _prediction_state(state: TrainState, plan, dev) -> TrainState:
    """The state a test pass runs with: the run's own graph cache, else a
    new one where the pass can be captured (``capturable(plan)``, and
    not an FSDP2-sharded model, whose hooks run eagerly), without
    changing the caller's state."""
    if state.graphs is not None or state.eager_reason or hasattr(state.model, "reshard"):
        return state
    graphs = _step_graphs(dev) if capturable(plan) else None
    return dataclasses.replace(state, graphs=graphs)


def _prediction_model(config, training, model, cfg, device):
    if model is None or cfg is None:
        dev = resolve_device(device)
        model, cfg = create_model_config(config, dev)
        model.to(resolve_precision(training.get("precision", "fp32"), dev)[0])
    return model, cfg


def _multibranch_prediction(config, datasets, *, state=None, model=None, cfg=None,
                            device=None):
    """Prediction under the multibranch scheme: every branch's test split
    through the trained state, each sample's ``dataset_id`` routing it to
    its branch's heads, on every rank alike. Returns (error, per-task
    error, trues, preds) with trues/preds lists over branches of
    per-head arrays."""
    branch_sets = _branch_sets(config, datasets)
    trainset, valset, testset = ([s for b in branch_sets for s in b[i]] for i in range(3))
    config = update_config(config, trainset, valset, testset)
    _check_num_nodes_bound(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    batch_size = int(training.get("batch_size", 32))
    model, cfg = _prediction_model(config, training, model, cfg, device)
    dev = next(model.parameters()).device
    _, compute_dtype = resolve_precision(training.get("precision", "fp32"), dev)
    if state is None:
        state = restore_checkpoint_state(config, model)
    seg_plan = training.get("use_segment_plan", True)
    trips = needs_triplets(cfg.mpnn_type)
    state = _prediction_state(state, None, dev)
    total, n_graphs, tasks_total = 0.0, 0, None
    trues_b, preds_b = [], []
    # one map over every branch's test split: the batches keep the
    # structure the train steps had
    branch_tests = [[dataclasses.replace(x, dataset_id=bi) for x in b[2]]
                    for bi, b in enumerate(branch_sets)]
    shared_fields = optional_field_widths([s for bt in branch_tests for s in bt])
    for bt in branch_tests:
        loader = GraphLoader(
            bt, batch_size, with_triplets=trips, ensure_fields=shared_fields,
            with_segment_plan=True if seg_plan == "auto" else bool(seg_plan))
        err, tasks, trues, preds = run_test(
            model, cfg, state, loader, device=dev,
            compute_dtype=compute_dtype, compute_grad_energy=cfg.enable_interatomic_potential)
        ng = len(loader.dataset)
        total += float(err) * ng
        n_graphs += ng
        t = np.asarray(tasks)
        tasks_total = t * ng if tasks_total is None else tasks_total + t * ng
        trues_b.append(trues)
        preds_b.append(preds)
    denom = max(n_graphs, 1)
    return total / denom, tasks_total / denom, trues_b, preds_b


def run_prediction(
    config_source,
    datasets: Optional[Tuple] = None,
    *,
    state: Optional[TrainState] = None,
    model=None,
    cfg=None,
    device: Optional[Union[str, torch.device]] = None,
):
    """A test pass of a trained model over the config's test split (or
    ``datasets``' third entry). Returns (error, per-task error, true
    values, predicted values), one array per head (for an interatomic
    potential: graph energies, then forces). ``state``, ``model`` and
    ``cfg`` may come from ``run_training``; without a model one is built
    from the config on ``device`` (``None`` means ``cuda:LOCAL_RANK``),
    and without a state the run's checkpoint is restored into the model
    (``restore_checkpoint_state``). The pass runs on the model's device.

    Under the multibranch scheme ``datasets`` holds per-branch triples and
    trues/preds are keyed by branch. Under dp across several ranks every
    rank calls this together: the test split runs as one lockstep dp pass
    (each rank its slot, the node's shard across nodes), every rank
    returns every slot's samples in the JAX package's order, and across
    nodes the samples the equal shards leave out follow, evaluated on
    every rank. A dp plan takes that pass wherever a process group
    exists, at one rank too, as training does."""
    config = load_config(config_source)
    grouped = runtime.maybe_initialize_distributed()
    scheme = config["NeuralNetwork"].get("Training", {}).get("Parallelism", {}).get("scheme")
    if scheme == "multibranch":
        return _multibranch_prediction(config, datasets, state=state, model=model, cfg=cfg,
                                       device=device)
    if datasets is None:
        trainset, valset, testset = _ingest_datasets(config)
    else:
        in_cols = _input_cols(config)
        trainset, valset, testset = (select_input_features(d, in_cols) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    _check_num_nodes_bound(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    model, cfg = _prediction_model(config, training, model, cfg, device)
    dev = next(model.parameters()).device
    if state is None:
        state = restore_checkpoint_state(config, model)
    _, compute_dtype = resolve_precision(training.get("precision", "fp32"), dev)
    seg_plan = training.get("use_segment_plan", True)
    seg_plan = True if seg_plan == "auto" else bool(seg_plan)
    batch_size = int(training.get("batch_size", 32))
    trips = needs_triplets(cfg.mpnn_type)
    plan = _plan_for_world(config) if grouped else None
    if plan is not None and plan.scheme != "dp":
        plan = None
    state = _prediction_state(state, plan, dev)
    kw = dict(device=dev, compute_dtype=compute_dtype,
              compute_grad_energy=cfg.enable_interatomic_potential)
    if plan is None:
        test_loader = GraphLoader(testset, batch_size, with_triplets=trips,
                                  with_segment_plan=seg_plan)
        return run_test(model, cfg, state, test_loader, **kw)
    _, _, sched = _dp_pad_schedules(plan, batch_size, 0, trips, (testset,) * 3)
    # the full set's map: per-shard maps could differ by node
    ensure = optional_field_widths(testset)
    base = GraphLoader(runtime.shard_dataset_for_process(testset), batch_size,
                       with_triplets=trips, with_segment_plan=seg_plan, fixed_pad=True,
                       spec_schedule=sched, ensure_fields=ensure)
    p = runtime.process_count()
    if sched is None and p > 1:
        _pin_full_worst_specs([(base, testset)], batch_size, trips)
    result = run_test(model, cfg, state,
                      runtime.wrap_loader(plan, base, superstep=False, device=dev),
                      plan=plan, **kw)
    # by index: a lazy container takes int indices only
    leftover = [testset[i] for i in range((len(testset) // p) * p, len(testset))]
    if not leftover:
        return result
    # the samples the equal node shards leave out, on every rank alike
    err_l, tasks_l, trues_l, preds_l = run_test(
        model, cfg, dataclasses.replace(state, graphs=None),
        GraphLoader(leftover, batch_size, with_triplets=trips, with_segment_plan=seg_plan,
                    ensure_fields=ensure),
        **kw)
    err_m, tasks_m, trues_m, preds_m = result
    n_m, n_l = len(testset) - len(leftover), len(leftover)
    tot = n_m + n_l
    return (
        (err_m * n_m + err_l * n_l) / tot,
        (np.asarray(tasks_m) * n_m + np.asarray(tasks_l) * n_l) / tot,
        [np.concatenate([a, b], axis=0) for a, b in zip(trues_m, trues_l)],
        [np.concatenate([a, b], axis=0) for a, b in zip(preds_m, preds_l)],
    )
