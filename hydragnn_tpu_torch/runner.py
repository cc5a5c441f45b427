"""End-to-end orchestration: ``run_training`` and ``run_prediction``.

Counterpart of ``hydragnn_tpu/runner.py`` on one device (``scheme:
single``): config loading, raw ingestion and splitting, ``update_config``,
model and optimizer construction, the epoch loop, and a test pass that
collects per-sample predictions. Both entry points run on ``"cuda"``
unless the caller passes another ``device`` (the tests pass ``"cpu"``).

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
delivers K-batch groups (``data/loader.SuperstepLoader``). On the card
every train, eval and test step runs through the run's CUDA-graph cache
(``train/capture.StepGraphs``, kept on the returned state), as the JAX
package runs every step through ``jax.jit``; a capture that fails
raises.

Checkpoints: every run saves its final state under
``./logs/<log_name>/`` (``utils/checkpoint.py``; ``Training.Checkpoint``
adds a save on every improving epoch), and ``run_prediction(config)``
given no state restores the run's ``latest`` checkpoint
(``restore_checkpoint_state``). ``Training.bn_recalibration`` refreshes
the running statistics at the end of training from an eval-shaped,
unpacked loader over the train split.

Refused with ``NotImplementedError`` naming the ROADMAP item that ports
it: data-parallel and multibranch schemes (Queue 1 item 11), the
parallel input pipeline (item 10), ``continue``
(resume) and the divergence guard (item 12), and dataset formats other
than the raw LSMS text files (item 10). An interatomic-potential config
(``enable_interatomic_potential``) trains on the energy + force loss,
and ``run_prediction`` then returns graph energies and forces.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from hydragnn_tpu_torch.config import load_config, save_config, update_config
from hydragnn_tpu_torch.data.graph import GraphSample, select_input_features
from hydragnn_tpu_torch.data.loader import GraphLoader, SuperstepLoader, split_dataset
from hydragnn_tpu_torch.data.padschedule import (
    dataset_size_arrays,
    fit_pack_budgets,
    packing_beats_ladder,
)
from hydragnn_tpu_torch.data.raw import process_raw_samples, read_lsms_directory
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.create import create_model_config, needs_triplets
from hydragnn_tpu_torch.parallel.runtime import _superstep_from_config, resolve_superstep_k
from hydragnn_tpu_torch.train.capture import StepGraphs
from hydragnn_tpu_torch.train.loop import bn_recalibration_epochs, train_validate_test
from hydragnn_tpu_torch.train.loop import test as run_test
from hydragnn_tpu_torch.train.optimizer import grad_clip_norm, select_optimizer
from hydragnn_tpu_torch.train.state import TrainState, resolve_precision
from hydragnn_tpu_torch.utils.checkpoint import find_continue_log_name, load_checkpoint
from hydragnn_tpu_torch.utils.print_utils import (
    get_log_name_config,
    print_distributed,
    setup_log,
)


def _ingest_datasets(config: dict) -> Tuple[List[GraphSample], ...]:
    """train/val/test GraphSamples from the raw LSMS text directories of
    ``Dataset.path`` (one ``total`` directory split by ``perc_train``, or
    one per split); normalization statistics come from all of them."""
    ds = config.get("Dataset", {})
    fmt = ds.get("format", "unit_test")
    if fmt not in ("unit_test", "LSMS"):
        raise NotImplementedError(
            f"Dataset.format {fmt!r} is not ported yet (the port reads the raw "
            "LSMS text format): ROADMAP Queue 1 item 10"
        )
    paths = ds.get("path", {})
    if not isinstance(paths, dict):
        raise ValueError(f"Dataset.path must be a dict, got {type(paths)}")
    training = config["NeuralNetwork"]["Training"]
    if "total" in paths:
        samples = process_raw_samples(read_lsms_directory(paths["total"], ds), config)
        return split_dataset(
            samples,
            float(training.get("perc_train", 0.7)),
            stratified=bool(ds.get("compositional_stratified_splitting", False)),
        )
    raws = {split: read_lsms_directory(paths[split], ds)
            for split in ("train", "validate", "test")}
    samples = process_raw_samples(raws["train"] + raws["validate"] + raws["test"], config)
    n_tr, n_va = len(raws["train"]), len(raws["validate"])
    return samples[:n_tr], samples[n_tr : n_tr + n_va], samples[n_tr + n_va :]


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
    max_n = max((s.num_nodes for ds in datasets for s in ds), default=0)
    if max_n > int(bound):
        raise ValueError(
            f"Graph with {max_n} nodes exceeds Architecture.num_nodes="
            f"{bound}; raise num_nodes (it must bound every split)"
        )


def _refuse_unported(config: dict) -> None:
    """Raise on every configured feature this slice does not port."""
    training = config["NeuralNetwork"].get("Training", {})
    par = training.get("Parallelism", {})
    scheme = par.get("scheme", "auto")
    if scheme not in ("auto", "single"):
        raise NotImplementedError(
            f"Parallelism scheme {scheme!r} is not ported yet (the port trains "
            "on one device): ROADMAP Queue 1 item 11"
        )
    if int(par.get("pipeline", {}).get("workers", 0) or 0) > 0:
        raise NotImplementedError(
            "the parallel input pipeline is not ported yet (the port collates "
            "serially): ROADMAP Queue 1 item 10"
        )
    if training.get("continue"):
        raise NotImplementedError(
            "continue (resuming a run from its checkpoint) is not ported yet: "
            "ROADMAP Queue 1 item 12"
        )
    guard = training.get("Guard", False)
    if guard.get("enabled", True) if isinstance(guard, dict) else guard:
        raise NotImplementedError(
            "the divergence guard is not ported yet: ROADMAP Queue 1 item 12"
        )


def packing_settings(config: dict) -> dict:
    """The ``Training.Parallelism.packing`` block resolved with the JAX
    package's strict grammar: ``enabled`` is ``"auto"`` (the default),
    ``True`` or ``False`` (boolean spellings accepted, anything else
    raises), plus ``max_budgets``, ``slack`` and ``max_graphs``."""
    par = config["NeuralNetwork"].get("Training", {}).get("Parallelism", {})
    pk = dict(par.get("packing", {}))
    enabled = pk.get("enabled", "auto")
    if isinstance(enabled, str):
        word = enabled.strip().lower()
        if word == "auto":
            enabled = "auto"
        elif word in ("1", "true", "yes", "on"):
            enabled = True
        elif word in ("", "0", "false", "no", "off"):
            enabled = False
        else:
            raise ValueError(
                f"Parallelism.packing.enabled: {enabled!r} not recognized "
                '(use true/false/"auto")'
            )
    slack, max_graphs = pk.get("slack"), pk.get("max_graphs")
    return {
        "enabled": enabled if enabled == "auto" else bool(enabled),
        "max_budgets": max(1, int(pk.get("max_budgets", 2))),
        "slack": None if slack is None else float(slack),
        "max_graphs": None if max_graphs is None else int(max_graphs),
    }


def resolve_packing(pk: dict, batch_size: int, trainset, seed: int = 0, *,
                    trips: bool = False, verbosity: int = 0) -> tuple:
    """``(packing_on, train_budgets, slack)`` for the single scheme, as
    the JAX runner's ``_resolve_packing`` decides: ``"auto"`` packs when
    ``packing_beats_ladder`` finds the fitted budgets beat the ladder
    (the run's unpacked baseline, ``fixed_pad="auto"``) on the train
    split's sizes and ``seed``; ``True`` fits the budgets. The slack is
    the train fit's, which the eval loaders reuse. A triplet-bearing
    model (``trips``) or an empty train split never packs; an explicit
    request then says why."""
    mode = pk["enabled"]
    if not mode:
        return False, None, None
    blocked = None
    if trips:
        blocked = "packing budgets do not cover triplet counts"
    elif not len(trainset):
        blocked = "empty training set"
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
        won = packing_beats_ladder(ns, es, batch_size, **kw)
        return (False, None, None) if won is None else (True, won[0], won[1])
    if pk["slack"] is not None:
        return True, fit_pack_budgets(ns, es, batch_size, **kw), pk["slack"]
    budgets, meta = fit_pack_budgets(ns, es, batch_size, with_meta=True, **kw)
    return True, budgets, meta["slack"]


def _with_supersteps(settings: dict, loader):
    """``loader`` delivering superstep groups of the K it resolves to
    (itself when K is 1)."""
    k = resolve_superstep_k(settings, loader)
    return SuperstepLoader(loader, k) if k > 1 else loader


def _step_graphs(dev: torch.device) -> Optional[StepGraphs]:
    """The run's CUDA-graph cache on a card; None on the CPU."""
    return StepGraphs(dev) if dev.type == "cuda" else None


def run_training(
    config_source,
    datasets: Optional[Tuple[Sequence[GraphSample], ...]] = None,
    *,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
):
    """Train end to end from a JSON config (path or dict) on one device
    (``None`` means ``"cuda"``). ``datasets`` may give (train, val, test)
    sample lists instead of ``Dataset.path``. Every batch carries the
    block plan at the Hopper tiles unless ``Training.use_segment_plan``
    is false, so each aggregation runs K1 forward and K2 backward;
    batches are bin-packed where ``resolve_packing`` says so, and
    grouped into supersteps where ``Parallelism.superstep`` resolves to
    K > 1. On the card every step replays a captured CUDA graph
    (``state.graphs``).

    Returns (state, model, cfg, history, config)."""
    config = load_config(config_source)
    _refuse_unported(config)
    dev = resolve_device(device)
    verbosity = int(config.get("Verbosity", {}).get("level", 0))
    if datasets is None:
        trainset, valset, testset = _ingest_datasets(config)
    else:
        in_cols = _input_cols(config)
        trainset, valset, testset = (select_input_features(d, in_cols) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    _check_num_nodes_bound(config, trainset, valset, testset)
    log_name = get_log_name_config(config)
    if verbosity > 0:
        setup_log(log_name)
    save_config(config, log_name)
    config["_log_name"] = log_name

    training = config["NeuralNetwork"]["Training"]
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
    pk = packing_settings(config)
    packed, budgets, slack = resolve_packing(pk, batch_size, trainset, seed,
                                             trips=trips, verbosity=verbosity)
    pack_kw = dict(packing=packed, pack_max_budgets=pk["max_budgets"],
                   pack_slack=slack, pack_max_graphs=pk["max_graphs"])
    if packed:
        print_distributed(
            verbosity, 2,
            "packing: on, train budgets "
            f"{[(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]}",
        )
    train_loader = GraphLoader(
        trainset, batch_size, shuffle=True, seed=seed, fixed_pad="auto",
        with_triplets=trips, with_segment_plan=seg_plan, pack_budgets=budgets,
        **pack_kw,
    )
    val_loader, test_loader = (
        GraphLoader(ds, batch_size, fixed_pad="auto", with_triplets=trips,
                    with_segment_plan=seg_plan, cache_batches=True, **pack_kw)
        for ds in (valset, testset)
    )
    # The recalibration reads plain unpacked batches of the train split,
    # as eval batches them (the JAX runner's recal_loader).
    recal_loader = (
        GraphLoader(trainset, batch_size, with_triplets=trips, with_segment_plan=seg_plan)
        if bn_recalibration_epochs(training) else None
    )
    superstep = _superstep_from_config(training.get("Parallelism", {}))
    train_loader, val_loader, test_loader = (
        _with_supersteps(superstep, ld) for ld in (train_loader, val_loader, test_loader))
    if isinstance(train_loader, SuperstepLoader):
        print_distributed(verbosity, 2, f"supersteps: K = {train_loader.k}")
    state = TrainState(model, select_optimizer(model.parameters(), training),
                       graphs=_step_graphs(dev))
    state, hist = train_validate_test(
        model, cfg, state, train_loader, val_loader, test_loader, config,
        device=dev, compute_dtype=compute_dtype,
        clip_norm=grad_clip_norm(training), verbosity=verbosity,
        log_name=log_name, recal_loader=recal_loader,
    )
    return state, model, cfg, hist, config


def restore_checkpoint_state(config: dict, model) -> TrainState:
    """A ``TrainState`` for ``model`` with the optimizer ``Training``
    names, loaded from the run's ``latest`` checkpoint (or its newest
    restorable epoch file). A config that came back from
    ``run_training`` names its run directory (``_log_name``); a fresh
    one derives it, and when that directory holds no checkpoint
    (``num_epoch`` changed since training), ``find_continue_log_name``
    finds the run that does."""
    training = config["NeuralNetwork"]["Training"]
    state = TrainState(model, select_optimizer(model.parameters(), training))
    log_name = config.get("_log_name") or find_continue_log_name(
        get_log_name_config(config)
    )
    return load_checkpoint(log_name, state)


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
    from the config on ``device`` (``None`` means ``"cuda"``), and
    without a state the run's checkpoint is restored into the model
    (``restore_checkpoint_state``). The pass runs on the model's
    device."""
    config = load_config(config_source)
    _refuse_unported(config)
    if datasets is None:
        trainset, valset, testset = _ingest_datasets(config)
    else:
        in_cols = _input_cols(config)
        trainset, valset, testset = (select_input_features(d, in_cols) for d in datasets)
    config = update_config(config, trainset, valset, testset)
    _check_num_nodes_bound(config, trainset, valset, testset)
    training = config["NeuralNetwork"]["Training"]
    if model is None or cfg is None:
        dev = resolve_device(device)
        model, cfg = create_model_config(config, dev)
        model.to(resolve_precision(training.get("precision", "fp32"), dev)[0])
    dev = next(model.parameters()).device
    if state is None:
        state = restore_checkpoint_state(config, model)
    if state.graphs is None:
        state.graphs = _step_graphs(dev)
    _, compute_dtype = resolve_precision(training.get("precision", "fp32"), dev)
    seg_plan = training.get("use_segment_plan", True)
    test_loader = GraphLoader(
        testset, int(training.get("batch_size", 32)),
        with_triplets=needs_triplets(cfg.mpnn_type),
        with_segment_plan=True if seg_plan == "auto" else bool(seg_plan),
    )
    return run_test(
        model, cfg, state, test_loader, device=dev, compute_dtype=compute_dtype,
        compute_grad_energy=cfg.enable_interatomic_potential,
    )
