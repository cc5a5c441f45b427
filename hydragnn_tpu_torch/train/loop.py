"""Training / validation / test loops.

Counterpart of ``hydragnn_tpu/train/loop.py``: ``make_train_step``,
``make_eval_step``, ``fold_step_metrics``, ``make_superstep_fn``,
``superstep_task_count``, ``History``, ``train_validate_test`` (any
feed, with superstep groups) and ``test``. An epoch runs each
batch's step on the device and keeps the graph-weighted loss sums there;
the host fetches them once at the end of the epoch (the JAX loop's
discipline), never per step. The plateau scheduler steps on the
validation loss and early stopping follows ``Training.EarlyStopping``/
``patience``, as in the JAX loop. With ``compute_grad_energy`` (an
interatomic potential) the steps take the energy + force loss of
``train/mlip.py`` (three per-task losses: energy, energy per atom,
force), and the collecting test pass returns [graph energies, forces].

Where ``jax.jit`` compiles each step once per shape, the port on the
card runs every train, eval and test step through a ``StepGraphs``
cache (``train/capture.py``): eager the first time a shape is seen,
captured as a CUDA graph the second, replayed after that. A superstep
group (``data/loader.MacroBatch``) of K batches is one graph of K steps
on the card, and K eager steps on the CPU; either way its per-step
losses fold into the epoch's sums as K single steps would
(``fold_step_metrics``), so K does not change a result.

Checkpoints go through the run's ``utils/checkpoint.CheckpointWriter``:
with ``Training.Checkpoint`` on, every epoch that improves the
validation loss (from epoch ``checkpoint_warmup`` on) saves its epoch
file and ``latest``, keeping the newest ``checkpoint_keep`` (5), and
``Checkpoint.interval_steps`` adds a resume container every that many
steps (between dispatches) and at each epoch's end; every run saves
``latest`` at its end, after the end-of-training batch-norm
recalibration (``recalibrate_batch_stats``,
``Training.bn_recalibration``). Each save carries the resume manifest
(the cursor, the epoch's partial sums bit for bit, the scheduler's,
early stopping's and the history's host state); a ``resume`` manifest
restores them and fast-forwards the train loader (``skip_to``), so a
resumed run continues the interrupted one bit for bit. The walltime
stop (``utils/runtime.check_remaining``) saves and ends the loop.

The divergence guard (``train/guard.py``, ``Training.Guard``): the
guarded train body saves the state it writes, checks the loss and the
gradient norm, and selects the old state back on a non-finite step,
inside the step (and its captured graph); ``GuardMonitor`` reads the
predicates at the epoch's end and escalates: a rollback restores the
writer's newest container in place, backs the learning rate off and
skips past the bad steps. Under the multibranch scheme the predicate
and the monitor's windows are per slot (each branch decoder, then the
encoder: ``guard.BranchSlots``). Armed ``nan`` fault rules are read when
a step is built and key its graph.

Under a dp or multibranch ``plan`` (``parallel/runtime.ParallelPlan``)
the epoch loop runs ``parallel/dp.make_dp_superstep_fn``'s steps (the
JAX loop's scheme dispatch, ``build_steps``): each rank's step on its
slot, reduced over the ranks, so every rank holds the same history; the
end-of-training batch-norm recalibration is skipped there with a
message, as in the JAX package, and ``test`` gathers the slots' per-
sample outputs in the JAX package's order.

Run telemetry (``utils/telemetry.py``, ``Training.Telemetry``): each
epoch pass builds a ``StepClock`` off the active stream (None with the
stream off, so the loop pays one ``is None`` test per dispatch); it
gets one ``step`` row per dispatch and per-spec ``spec_rollup`` rows
with the live MFU, and counts each key's first dispatch into an
``executable`` row. Every epoch emits an ``epoch`` row carrying the
``History`` floats verbatim and a ``memory`` row. The tracer
(``utils/tracer.py``) times the ``{region}/dataload``, ``/step`` and
``/dispatch_gap`` regions when installed, and ``Training.Profiling``
opens a ``torch.profiler`` window over one epoch, each dispatch inside a
``train_step``/``eval_step`` range.

The feed (``parallel/runtime.wrap_loader``: collation workers or the
prefetch thread) hands the loop host batches; the loop thread makes the
one copy to the card. Where the chain holds a
``data/pipeline.ParallelPipelineLoader``, each dispatch's host-to-device
time on the card (the graph cache's ``h2d_seconds``) goes into its
``PipelineStats``, and after each pass (its last copy recorded) the
loop flushes the stats and samples the pass's starved deliveries as
``{region}/pipeline_starved_steps``.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.data.loader import MacroBatch, feed_supports_skip
from hydragnn_tpu_torch.data.pipeline import pipeline_stats
from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.train import guard as guard_mod
from hydragnn_tpu_torch.train.losses import multihead_loss
from hydragnn_tpu_torch.train.mlip import (
    energy_and_forces,
    energy_force_loss,
    energy_force_loss_terms,
)
from hydragnn_tpu_torch.train.optimizer import (
    OptaxOptimizer,
    ReduceLROnPlateau,
    clip_by_global_norm_,
    get_learning_rate,
    set_learning_rate,
)
from hydragnn_tpu_torch.train.state import TrainState, cast_batch
from hydragnn_tpu_torch.utils import faults, telemetry
from hydragnn_tpu_torch.utils import tracer as tr
from hydragnn_tpu_torch.utils.checkpoint import (
    checkpoint_settings,
    decode_acc,
    load_resume_checkpoint,
)
from hydragnn_tpu_torch.utils.print_utils import print_distributed
from hydragnn_tpu_torch.utils.runtime import check_remaining


def _graph_count(batch) -> torch.Tensor:
    return batch.graph_mask.sum().to(torch.float32)


def _train_body(model, optimizer, cfg, compute_dtype, clip_norm, compute_grad_energy,
                red=None, *, clip_groups: bool = False, guard: bool = False,
                rules: Optional[dict] = None, slots=None):
    """``body(batch, counter) -> (loss, per_task, n_graphs)``: one
    optimizer step on a batch already on the model's device, with no
    host sync (so it can be captured); ``counter`` is the train state's
    device step counter, which it advances. The gradients stay in
    ``.grad`` until the next step. With ``red`` (a
    ``parallel/dp.Reduction``) it is one rank's step of a dp or
    multibranch plan: the loss weighted before the backward; the
    gradients, running statistics and loss terms reduced over the ranks
    after it; ``n_graphs`` the global count. ``clip_groups`` clips each
    optimizer group on its own (the dual optimizer's two optax chains).

    ``guard`` adds the divergence guard (``train/guard.py``): the body
    saves what it writes first, and returns ``(loss, per_task,
    n_graphs, ok, gnorm)``, the first three zeroed and the state kept on
    a non-finite step. ``rules`` are the armed ``nan`` fault rules
    (``guard.nan_injections()``), selected in against ``counter``.
    ``slots`` (a ``guard.BranchSlots``, the multibranch guard) makes
    ``ok`` and ``gnorm`` vectors over the slots, the norms taken before
    the decoder rescale."""
    params = list(model.parameters())
    scale = float(red.n_slots) if red is not None and red.fsdp else 1.0
    shadow = guard_mod.StateShadow(model, optimizer, slots) if guard else None
    rules = rules or {}
    joined = ()
    if guard and slots is not None:
        slot_of = [slots.slot(p) for p in params]
        if clip_norm > 0:
            groups = [g["params"] for g in optimizer.param_groups] if clip_groups else [params]
            spans = ({slots.slot(p) for p in group} for group in groups)
            joined = tuple(torch.tensor(sorted(s), device=params[0].device)
                           for s in spans if len(s) > 1)

    def body(batch, counter):
        batch = guard_mod.poison_batch(rules, counter, batch)
        b = cast_batch(batch, compute_dtype)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if shadow is not None:
            shadow.save()
        if red is not None:
            w, n_graphs = red.weight(b)
        if compute_grad_energy:
            tot, tasks = energy_force_loss(model, b, cfg)
        else:
            tot, tasks = multihead_loss(model(b), b, cfg)
        if red is None:
            tot.backward()
            live, n_graphs = params, _graph_count(b)
        else:
            (tot * (w * scale).to(tot.dtype).reshape(())).backward()
            red.after_forward()
            live = list(model.parameters())  # FSDP2's shards, once resharded
        tot = guard_mod.poison_scalar(rules, "loss", counter, tot.detach())
        # A parameter the loss does not reach takes a zero gradient, as in
        # optax, so AdamW's weight decay still moves it.
        for p in live:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        guard_mod.poison_grads(rules, counter, live)
        if red is not None:
            tot, tasks = red.reduce_train(live, tot, tasks, w.reshape(()))
        if guard and slots is not None:
            gnorm = guard_mod.slot_norms([p.grad for p in live], slot_of, len(slots.labels))
        elif guard:
            gnorm = guard_mod.global_norm([p.grad for p in live])
        if red is not None:
            red.rescale()
        if clip_norm > 0:
            groups = [g["params"] for g in optimizer.param_groups] if clip_groups else [live]
            for group in groups:
                clip_by_global_norm_(group, clip_norm)
        optimizer.step()
        counter.add_(1)
        if guard:
            return guard_mod.guarded_commit(shadow, tot, tasks.detach(),
                                            n_graphs.reshape(()), gnorm, joined)
        return tot, tasks.detach(), n_graphs.reshape(())

    return body


def _eval_body(model, cfg, compute_dtype, collect_outputs, compute_grad_energy, red=None):
    """``body(batch) -> (loss, per_task, n_graphs[, *outputs])`` in eval
    mode without parameter gradients (no host sync). With ``red`` the
    loss is the graph-weighted mean over the plan's slots
    (``_weighted_eval_over_devices``) and ``outputs`` are this rank's
    own."""

    def body(batch):
        b = cast_batch(batch, compute_dtype)
        model.eval()
        if red is not None:
            w, n_graphs = red.weight(b)
        if compute_grad_energy:
            with torch.enable_grad():
                ge, forces = energy_and_forces(model, b, cfg, create_graph=False)
            ge, forces = ge.detach(), forces.detach()
            tot, tasks = energy_force_loss_terms(ge, forces, b, cfg)
            outputs = (ge[:, None], forces)
        else:
            with torch.no_grad():
                outputs = tuple(model(b))
                tot, tasks = multihead_loss(outputs, b, cfg)
        if red is None:
            n_graphs = _graph_count(b)
        else:
            red.after_forward()
            tot, tasks = red.reduce_eval(tot.detach(), tasks.detach(),
                                         w.reshape(()).to(tot.dtype))
        return (tot, tasks, n_graphs.reshape(())) + (outputs if collect_outputs else ())

    return body


def _step_key(red, *key) -> tuple:
    """A step's graph-cache key: a plan's steps are keyed apart by its
    reduction kind (``("dp", "train", ...)``)."""
    return key if red is None else (red.kind,) + key


def _train_key(red, compute_dtype, guard: bool, rules: dict) -> tuple:
    """A train step's key: a guarded build, and a build with armed
    ``nan`` rules, never share an unguarded or unarmed build's graph."""
    key = _step_key(red, "train", compute_dtype)
    if guard:
        key += ("guard",)
    if rules:
        key += (("nan",) + guard_mod.rules_key(rules),)
    return key


def make_train_step(
    model: torch.nn.Module,
    optimizer: OptaxOptimizer,
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
    clip_norm: float = 0.0,
    compute_grad_energy: bool = False,
    red=None,
    clip_groups: bool = False,
    guard: bool = False,
    slots=None,
) -> Callable:
    """``step(state, batch) -> (state, loss, per_task)``: one eager
    optimizer step on a batch already on the model's device. The losses
    come back as device tensors (no host sync); the gradients stay in
    ``.grad`` until the next step. ``compute_grad_energy`` trains on the
    MLIP energy + force loss, whose backward differentiates the force
    pass. ``red`` and ``clip_groups``: ``_train_body``. ``guard`` returns
    ``(state, loss, per_task, n_graphs, ok, gnorm)``, as the JAX
    package's guarded step does; armed ``nan`` rules are read here.
    ``slots``: ``_train_body``."""
    body = _train_body(model, optimizer, cfg, compute_dtype, clip_norm, compute_grad_energy,
                       red, clip_groups=clip_groups, guard=guard,
                       rules=guard_mod.nan_injections(), slots=slots)

    def step(state: TrainState, batch):
        out = body(batch, state.step_t)
        state.step += 1
        return (state,) + tuple(out if guard else out[:2])

    return step


def make_eval_step(
    model: torch.nn.Module,
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
    collect_outputs: bool = False,
    compute_grad_energy: bool = False,
    red=None,
) -> Callable:
    """``step(state, batch) -> (loss, per_task[, outputs])`` in eval mode
    without parameter gradients, run eagerly. With
    ``compute_grad_energy`` the forces take a gradient with respect to
    the positions only (no graph is kept), and the outputs are [graph
    energies [G, 1], forces [N, 3]]. ``red``: ``_eval_body``."""
    body = _eval_body(model, cfg, compute_dtype, collect_outputs, compute_grad_energy, red)

    def step(state: TrainState, batch):
        del state
        out = body(batch)
        return (out[0], out[1], list(out[3:])) if collect_outputs else out[:2]

    return step


def fold_step_metrics(acc, tots, tasks, gs):
    """Fold K steps' ``(loss [K], per_task [K, T], graphs [K])`` rows into
    the epoch accumulator ``(loss_sum, tasks_sum, n_graphs)`` (None
    before the first step) with exactly the per-step op sequence: each
    product rounded, then the adds chained in step order, so K steps
    folded at once give the bits K single steps give. (Each torch op is
    its own kernel, so no product is contracted into an add, the hazard
    the JAX package's version fences against.)"""
    prod_l = tots * gs
    prod_t = tasks * gs[:, None]
    for i in range(gs.shape[0]):
        if acc is None:
            # gs may be a graph's output, which its next replay rewrites
            acc = (prod_l[i], prod_t[i], gs[i].clone())
        else:
            acc = (acc[0] + prod_l[i], acc[1] + prod_t[i], acc[2] + gs[i])
    return acc


def _spec_key(batch) -> tuple:
    """A batch's padded shape: nodes, edges, graphs and triplets (None
    without), which the step graphs key on."""
    t = None if batch.t_kj is None else int(batch.t_kj.shape[0])
    return (batch.num_nodes, batch.num_edges, batch.num_graphs, t)


def _steps_fn(body, rows: int = 3) -> Callable:
    """K steps of ``body`` over K device batches: ``rows`` stacked
    outputs (``(loss [K], per_task [K, T], graphs [K])``, and a guarded
    step's ``ok [K], gnorm [K]``), then each step's extra outputs. A
    train body takes the device step counter (``counter``). The graph
    count is the body's (the global one under dp)."""

    def run(batches, counter=None):
        outs = [body(b) if counter is None else body(b, counter) for b in batches]
        out = tuple(torch.stack([r[i] for r in outs]) for i in range(rows))
        return out + tuple(x for r in outs for x in r[rows:])

    return run


# Every step dispatch of this process since it started, by what it ran:
# model forwards (one a train or eval step) and, of those, train steps.
# A caller reads the difference over a run (drivers/multibranch_hpo.py's
# ranks count each trial's steps beside its K1/K2 launches).
DISPATCHES = {"forwards": 0, "train_steps": 0}


def _dispatch(run, graphs, key, batches, device, counter=None):
    """``run`` over host batches: through the graph cache on the card,
    eagerly on ``device`` otherwise. ``counter`` (a telemetry
    ``ExecCounter``) counts the key's first eager run."""
    DISPATCHES["forwards"] += len(batches)
    if "train" in key[:2]:  # ("train", ...) or a plan's ("dp", "train", ...)
        DISPATCHES["train_steps"] += len(batches)
    if graphs is None:
        dev = [b.to(device) for b in batches]
        return run(dev) if counter is None else counter.run(run, dev)
    return graphs.run(key + (len(batches),) + _spec_key(batches[0]), run, batches,
                      counter=counter)


def make_superstep_fn(
    model: torch.nn.Module,
    optimizer: Optional[OptaxOptimizer],
    cfg: ModelConfig,
    *,
    train: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    clip_norm: float = 0.0,
    compute_grad_energy: bool = False,
    device: Optional[torch.device] = None,
    graphs=None,
    red=None,
    clip_groups: bool = False,
    guard: bool = False,
    slots=None,
) -> Callable:
    """The superstep: K train (or eval) steps over a list of K batches of
    one shape in one dispatch. With ``graphs`` (a ``StepGraphs``, on the
    card) it is one captured graph of K steps over K static buffers that
    the host fills with one copy; without, K eager steps on ``device``.
    ``red`` and ``clip_groups`` make them a plan's steps (``_train_body``;
    ``parallel/dp.make_dp_superstep_fn``).

    Train signature ``(state, acc, batches) -> (state, acc)``; eval
    ``(state, acc, batches) -> acc``, where ``acc = (loss_sum, tasks_sum,
    n_graphs)`` are the f32 weighted partial sums of the epoch (None
    before its first step), folded by ``fold_step_metrics``: one K-step
    dispatch gives the bits of K single-step dispatches. ``guard``
    (train only) runs the guarded body per inner step, so a poisoned
    batch inside a K-step graph is skipped alone, and returns ``(state,
    acc, oks [K], gnorms [K])`` (copies of the graph's outputs, which
    the guard's monitor holds to the epoch's end). The armed ``nan``
    rules are read here and join the graph's key; ``slots`` makes the
    predicates per slot (``_train_body``). ``probe`` (the step
    clock's, ``utils/telemetry``) takes the dispatch's raw outputs and
    may carry a counter for its first run."""
    if train:
        rules = guard_mod.nan_injections()
        body = _train_body(model, optimizer, cfg, compute_dtype, clip_norm,
                           compute_grad_energy, red, clip_groups=clip_groups, guard=guard,
                           rules=rules, slots=slots)
        key = _train_key(red, compute_dtype, guard, rules)
    else:
        body = _eval_body(model, cfg, compute_dtype, False, compute_grad_energy, red)
        key = _step_key(red, "eval", compute_dtype)
    run = _steps_fn(body, 5 if train and guard else 3)

    def superstep(state, acc, batches, probe=None):
        fn = functools.partial(run, counter=state.step_t) if train else run
        if probe is None or probe.counter is None:
            out = _dispatch(fn, graphs, key, batches, device)
        else:
            out = _dispatch(fn, graphs, key, batches, device, counter=probe.counter)
        if probe is not None:
            probe.out = out
        acc = fold_step_metrics(acc, *out[:3])
        if not train:
            return acc
        state.step += len(batches)
        if guard:
            return state, acc, out[3].clone(), out[4].clone()
        return state, acc

    return superstep


def superstep_task_count(cfg: ModelConfig) -> int:
    """Length of the per-task loss vector: 3 for the MLIP loss (energy,
    energy/atom, force), one per head otherwise."""
    return 3 if cfg.enable_interatomic_potential else len(cfg.heads)


@dataclass
class History:
    train_loss: List[float] = field(default_factory=list)
    val_loss: List[float] = field(default_factory=list)
    test_loss: List[float] = field(default_factory=list)
    train_tasks: List[np.ndarray] = field(default_factory=list)
    val_tasks: List[np.ndarray] = field(default_factory=list)
    test_tasks: List[np.ndarray] = field(default_factory=list)
    lr: List[float] = field(default_factory=list)
    epoch_seconds: List[float] = field(default_factory=list)
    # CUDA graphs captured during each epoch (0 on the CPU).
    epoch_captures: List[int] = field(default_factory=list)


def _fetch_epoch(loss_sum, tasks_sum, n_graphs) -> Tuple[float, np.ndarray]:
    """The one host fetch of an epoch: (mean loss, mean per-task)."""
    # graftlint: disable-next-line=host-sync -- the ONE amortized metrics fetch this loop exists to provide (vs the reference's per-batch .item())
    vals = torch.cat(
        [loss_sum.reshape(1).double(), tasks_sum.reshape(-1).double(),
         n_graphs.reshape(1).double()]
    ).cpu().numpy()
    denom = max(float(vals[-1]), 1.0)
    return float(vals[0]) / denom, vals[1:-1] / denom


def _run_epoch(superstep, state, loader, *, train: bool, acc0=None, step0: int = 0,
               step_hook=None, guard=None):
    """One pass over the loader: each delivery (a batch, or a
    ``MacroBatch`` of K) is one superstep dispatch; the weighted partial
    sums accumulate on the device and are fetched once at the end.

    Mid-epoch resume: ``acc0`` (``checkpoint.decode_acc``'s float32
    values) seeds the sums and ``step0`` the epoch's step count, the
    loader having been fast-forwarded to the same cursor.
    ``step_hook(state, steps_done, acc)`` runs after every dispatch (the
    writer's interval saves, so cursors fall between dispatches). Each
    train step ticks the ``train_step`` fault site. ``guard`` (a
    ``GuardMonitor``; the superstep must be guarded) gets each
    dispatch's predicates and reads them after the sums' fetch; it may
    raise ``GuardRollback`` or ``GuardHalt``.

    Telemetry (module docstring): the epoch's ``StepClock`` times each
    dispatch and takes its outputs through a probe; it is finished after
    the sums' fetch. ``HYDRAGNN_TPU_TRACE_LEVEL`` > 0 synchronizes the
    card after each dispatch, so the tracer's step regions time the
    device (at the cost of the host running ahead)."""
    acc = None
    dev = state.step_t.device
    if acc0 is not None:
        acc = tuple(torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in acc0)
    region = "train" if train else "eval"
    trace_env = os.environ.get("HYDRAGNN_TPU_TRACE_LEVEL", "").strip()
    trace_sync = trace_env.isdigit() and int(trace_env) > 0 and dev.type == "cuda"
    clock = telemetry.epoch_clock(loader, region, step0=step0)
    telemetry.note_phase(region)
    pstats = pipeline_stats(loader)
    starved_before = pstats.starved_steps if pstats is not None else 0
    graphs = state.graphs if pstats is not None else None
    n = step0
    max_k = 0
    prev_end = None
    it = iter(loader)
    while True:
        tr.start(f"{region}/dataload")
        t_fetch = time.perf_counter() if clock is not None else 0.0
        item = next(it, None)
        t_fetched = time.perf_counter() if clock is not None else 0.0
        tr.stop(f"{region}/dataload")
        if item is None:
            break
        is_macro = isinstance(item, MacroBatch)
        batches = item.batches if is_macro else [item]
        k = len(batches)
        n += k
        max_k = max(max_k, k)
        t_dispatch = time.perf_counter()
        if prev_end is not None:
            tr.sample(f"{region}/dispatch_gap", t_dispatch - prev_end)
        probe = None if clock is None else clock.probe(batches[0], k)
        kw = {} if probe is None else {"probe": probe}
        if graphs is not None:
            h2d = (graphs.h2d_seconds, graphs.h2d_batches)
        tr.start(f"{region}/step")
        with tr.step_annotation(f"{region}_step", n, batches[0], k):
            if not train:
                acc = superstep(state, acc, batches, **kw)
            elif guard is not None:
                state, acc, oks, gnorms = superstep(state, acc, batches, **kw)
            else:
                state, acc = superstep(state, acc, batches, **kw)
            if trace_sync:
                # graftlint: disable-next-line=host-sync -- HYDRAGNN_TPU_TRACE_LEVEL>0 opt-in: per-step barrier so tracer times device work, at the documented cost of the dispatch overlap
                torch.cuda.synchronize(dev)
        tr.stop(f"{region}/step")
        if graphs is not None:
            pstats.record_h2d(graphs.h2d_seconds - h2d[0], graphs.h2d_batches - h2d[1])
        tr.note_trace_step()
        prev_end = time.perf_counter()
        tr.sample(f"{region}/steps_per_dispatch", float(k))
        if clock is not None:
            clock.record(probe, step=n, k=k, batch=batches[0], is_macro=is_macro,
                         t_fetch_start=t_fetch, t_fetch_end=t_fetched,
                         t_dispatch_start=t_dispatch, t_dispatch_end=prev_end, acc=acc)
        if train:
            for _ in batches:
                faults.tick("train_step")
            if guard is not None:
                guard.observe(step=n, k=k, ok_ref=oks, gnorm_ref=gnorms)
        if step_hook is not None:
            step_hook(state, n, acc)
    if pstats is not None:
        pstats.flush_to_tracer()
        tr.sample(f"{region}/pipeline_starved_steps",
                  float(pstats.starved_steps - starved_before))
    pack = _packing_stats(loader)
    if pack is not None:
        tr.sample(f"{region}/pack_pad_ratio", float(pack["pad_ratio"]))
        tr.sample(f"{region}/pack_node_fill", float(pack["node_fill"]))
    if max_k > 1:
        tr.sample(f"{region}/superstep_k", float(max_k))
    loss, tasks = (0.0, np.zeros(1)) if acc is None else _fetch_epoch(*acc)
    if clock is not None:
        clock.finish()
    if guard is not None:
        guard.epoch_end()
    return state, loss, tasks


def _packing_stats(loader) -> Optional[dict]:
    """The current epoch's ``packing_stats`` of the packing loader in a
    wrapper chain (None when nothing in it packs)."""
    while loader is not None:
        fn = getattr(loader, "packing_stats", None)
        if callable(fn):
            return fn()
        loader = getattr(loader, "loader", None)
    return None


@torch.no_grad()
def recalibrate_batch_stats(
    model: torch.nn.Module,
    state: TrainState,
    loader,
    *,
    device: torch.device,
    compute_dtype: torch.dtype = torch.float32,
    epochs: int = 1,
) -> TrainState:
    """Replace every ``MaskedBatchNorm``'s running statistics with the
    exact pooled moments of the data in ``loader``, as the JAX package's
    ``recalibrate_batch_stats`` does: one train-mode forward per batch
    from zeroed running statistics (so each buffer then holds ``(1 -
    momentum)`` times that batch's masked moment, and train mode reads
    only batch statistics, so outputs are untouched), each batch's
    moments weighted by its real nodes and pooled in float64 on the host
    by the law of total variance, over ``epochs`` passes. Parameters do
    not change. The runner passes an eval-shaped, unpacked loader over
    the train split and runs this at the end of training only, before
    the final save. A model without batch norms, or an empty loader,
    leaves the state as it was."""
    bns = {name: m for name, m in model.named_modules() if isinstance(m, MaskedBatchNorm)}
    if epochs <= 0 or not bns:
        return state
    kept = {name: (m.mean.clone(), m.var.clone()) for name, m in bns.items()}
    was_training = model.training
    model.train()
    sums, weight = None, 0.0
    batches = (b for _ in range(int(epochs)) for item in loader
               for b in (item.batches if isinstance(item, MacroBatch) else [item]))
    for batch in batches:
        batch = batch.to(device)
        for m in bns.values():
            m.mean.zero_()
            m.var.zero_()
        model(cast_batch(batch, compute_dtype))
        # from a zero seed each buffer holds (1 - momentum) x the
        # batch's moment; one host fetch for all of them
        flat = torch.cat([torch.cat([m.mean, m.var]) / (1.0 - m.momentum)
                          for m in bns.values()]).double().cpu().numpy()
        w = float(batch.node_mask.sum())
        scaled, at = [], 0
        for m in bns.values():
            f = m.mean.numel()
            mean, var = flat[at:at + f], flat[at + f:at + 2 * f]
            scaled.append(np.stack([mean * w, (var + mean ** 2) * w]))
            at += 2 * f
        sums = scaled if sums is None else [a + b for a, b in zip(sums, scaled)]
        weight += w
    model.train(was_training)
    if sums is None or weight <= 0.0:
        for name, m in bns.items():
            m.mean.copy_(kept[name][0])
            m.var.copy_(kept[name][1])
        return state
    for m, tot in zip(bns.values(), sums):
        mean, sq = tot[0] / weight, tot[1] / weight
        m.mean.copy_(torch.from_numpy(mean.astype(np.float32)))
        m.var.copy_(torch.from_numpy(np.maximum(sq - mean ** 2, 0.0).astype(np.float32)))
    return state


def bn_recalibration_epochs(training: dict) -> int:
    """``Training.bn_recalibration`` (``N`` or ``{"enabled": true,
    "epochs": N}``) as a number of end-of-training passes (0 = off)."""
    raw = training.get("bn_recalibration", 0)
    if isinstance(raw, dict):
        if not raw.get("enabled", True):
            return 0
        return max(0, int(raw.get("epochs", 1)))
    return max(0, int(raw))


def _loop_state(hist: History, best_val: float, bad_epochs: int, scheduler) -> dict:
    """The loop's host state for the resume manifest (Python floats,
    which a checkpoint keeps exactly)."""
    return {
        "best_val": best_val,
        "bad_epochs": bad_epochs,
        "scheduler": {"best": scheduler.best, "bad_epochs": scheduler.bad_epochs},
        "hist": {
            "train_loss": list(hist.train_loss), "val_loss": list(hist.val_loss),
            "test_loss": list(hist.test_loss), "lr": list(hist.lr),
            "epoch_seconds": list(hist.epoch_seconds),
            "epoch_captures": list(hist.epoch_captures),
            **{name: [np.asarray(t, np.float64).reshape(-1).tolist()
                      for t in getattr(hist, name)]
               for name in ("train_tasks", "val_tasks", "test_tasks")},
        },
    }


def _restore_loop_state(ls: dict, hist: History, scheduler) -> Tuple[float, int]:
    """Load a manifest's loop state into ``hist`` and ``scheduler``;
    returns ``(best_val, bad_epochs)``."""
    sched = ls.get("scheduler") or {}
    scheduler.best = float(sched.get("best", scheduler.best))
    scheduler.bad_epochs = int(sched.get("bad_epochs", 0))
    h = ls.get("hist") or {}
    for name in ("train_loss", "val_loss", "test_loss", "lr", "epoch_seconds"):
        setattr(hist, name, [float(x) for x in h.get(name, [])])
    hist.epoch_captures = [int(x) for x in h.get("epoch_captures", [])]
    for name in ("train_tasks", "val_tasks", "test_tasks"):
        setattr(hist, name, [np.asarray(v, np.float64) for v in h.get(name, [])])
    return float(ls.get("best_val", float("inf"))), int(ls.get("bad_epochs", 0))


def _guard_rollback(rb, monitor, state, epoch, train_loader, writer, scheduler, verbosity):
    """After a ``GuardRollback``: restore the writer's newest resume
    container into ``state`` in place (the validate-finite gate kept
    every durable file finite), back the learning rate off in its
    tensor, and skip the train loader past the bad steps. Returns
    ``(state, acc0, step0)`` for the epoch's retry; raises ``GuardHalt``
    where there is nothing to roll back to. The device step counter is
    restored with the state, so it then lags the plan's cursor by the
    skipped steps (as in the JAX package)."""
    if writer is None:
        raise guard_mod.GuardHalt(
            "Guard.policy=rollback needs checkpointing: no CheckpointWriter is attached "
            "to this loop, so there is no last-known-good state to restore. "
            + monitor.report())
    writer.wait()
    try:
        state, manifest = load_resume_checkpoint(writer.log_name, state, fmt=writer.fmt)
    except FileNotFoundError as e:
        raise guard_mod.GuardHalt(
            f"Guard rollback found no restorable checkpoint ({e}) — the divergence landed "
            "before the first durable save; lower Training.Checkpoint.interval_steps. "
            + monitor.report())
    if manifest is None:
        raise guard_mod.GuardHalt(
            "Guard rollback needs a resume manifest but only a checkpoint without a "
            "cursor was restorable. " + monitor.report())
    me, ms = int(manifest.get("epoch", 0)), int(manifest.get("step", 0))
    if me != epoch:
        raise guard_mod.GuardHalt(
            f"Guard rollback: the newest container's cursor (epoch {me}, step {ms}) is not "
            f"in the current epoch {epoch}; refusing a cross-epoch restore. "
            + monitor.report())
    lr = get_learning_rate(state.optimizer)
    new_lr = max(lr * monitor.settings.lr_backoff, float(scheduler.min_lr))
    set_learning_rate(state.optimizer, new_lr)
    target = max(ms, max(rb.bad_steps) + 1) if rb.bad_steps else ms
    train_loader.set_epoch(epoch)
    if target > 0:
        train_loader.skip_to(target)
    acc0 = decode_acc(manifest.get("acc")) if ms > 0 else None
    monitor.note_rollback(target, new_lr)
    print_distributed(
        verbosity, 0,
        f"[guard] rollback: epoch {epoch} resumes at step {target} (container cursor "
        f"{ms}, bad steps {rb.bad_steps[-8:]}), lr {lr:.3e} -> {new_lr:.3e}")
    return state, acc0, target


def train_validate_test(
    model: torch.nn.Module,
    cfg: ModelConfig,
    state: TrainState,
    train_loader,
    val_loader,
    test_loader,
    config: dict,
    *,
    device: torch.device,
    compute_dtype: torch.dtype = torch.float32,
    clip_norm: float = 0.0,
    verbosity: int = 0,
    writer=None,
    resume: Optional[dict] = None,
    recal_loader=None,
    plan=None,
) -> Tuple[TrainState, History]:
    """The epoch loop: train, validate, test, step the plateau scheduler
    on the validation loss, stop early after ``patience`` epochs without
    improvement when ``EarlyStopping`` is set. The loaders may deliver
    ``MacroBatch`` groups (``data/loader.SuperstepLoader``); the steps
    run through ``state.graphs`` where the run has one (on the card).
    With a ``writer`` (``utils/checkpoint.CheckpointWriter``) the loop
    saves as the module docstring says; ``resume`` (a manifest of
    ``load_resume_checkpoint``, its state already restored) continues
    at its cursor. ``recal_loader`` is the feed of the end-of-training
    batch-norm recalibration (the train loader when None). ``plan``
    selects the dp or multibranch steps (module docstring).
    ``Training.Guard`` turns the guard on (module docstring)."""
    training = config["NeuralNetwork"]["Training"]
    num_epoch = int(training.get("num_epoch", 1))
    patience = int(training.get("patience", 10))
    early_stop = bool(training.get("EarlyStopping", False))
    ckpt = checkpoint_settings(training)
    use_ckpt = writer is not None and ckpt.enabled
    warmup = int(training.get("checkpoint_warmup", 0))
    gset = guard_mod.guard_settings(training)
    multibranch = plan is not None and plan.scheme == "multibranch"
    n_branches = len(plan.devices_per_branch) if multibranch else 0
    slots = None
    if multibranch and gset.enabled:
        from hydragnn_tpu_torch.parallel.multibranch import guard_slots

        slots = guard_slots(model, cfg, n_branches)
    monitor = (guard_mod.GuardMonitor(gset, verbosity=verbosity,
                                      branches=slots.labels if slots else None)
               if gset.enabled else None)
    graphs = state.graphs
    kw = dict(compute_dtype=compute_dtype, compute_grad_energy=cfg.enable_interatomic_potential,
              device=device, graphs=graphs)
    if plan is None or plan.scheme == "single":
        train_step = make_superstep_fn(model, state.optimizer, cfg, train=True,
                                       clip_norm=clip_norm, guard=gset.enabled, **kw)
        eval_step = make_superstep_fn(model, None, cfg, train=False, **kw)
    else:
        from hydragnn_tpu_torch.parallel.dp import make_dp_superstep_fn
        from hydragnn_tpu_torch.parallel.multibranch import decoder_grad_scales

        scales = (decoder_grad_scales(model, cfg, plan.data_parallel_size,
                                      plan.devices_per_branch)
                  if multibranch else None)
        train_step = make_dp_superstep_fn(model, state.optimizer, cfg, plan, train=True,
                                          clip_norm=clip_norm, kind=plan.scheme,
                                          decoder_scales=scales, guard=gset.enabled,
                                          slots=slots, **kw)
        eval_step = make_dp_superstep_fn(model, None, cfg, plan, train=False, **kw)
    sched_cfg = training.get("ReduceLROnPlateau", {})
    scheduler = ReduceLROnPlateau(
        factor=float(sched_cfg.get("factor", 0.5)),
        patience=int(sched_cfg.get("patience", 5)),
        min_lr=float(sched_cfg.get("min_lr", 1e-5)),
        threshold=float(sched_cfg.get("threshold", 1e-4)),
    )
    hist = History()
    best_val = float("inf")
    bad_epochs = 0
    can_skip = feed_supports_skip(train_loader)
    if resume is not None and int(resume.get("step", 0)) > 0 and not can_skip:
        print_distributed(
            verbosity, 0,
            f"resume container ignored: its cursor is mid-epoch (step {resume.get('step')} "
            f"of epoch {resume.get('epoch')}) but this feed has no skip_to fast-forward; "
            "restarting from epoch 0 with the restored weights")
        resume = None
    epoch_start = resume_step = 0
    resume_acc = resume_cursor = None
    if resume is not None:
        epoch_start, resume_step = int(resume.get("epoch", 0)), int(resume.get("step", 0))
        resume_acc = decode_acc(resume.get("acc"))
        # a multibranch feed checks the per-branch cursors' lockstep itself
        resume_cursor = resume.get("branch_steps") or resume_step
        best_val, bad_epochs = _restore_loop_state(resume.get("loop") or {}, hist, scheduler)
    interval = ckpt.interval_steps if use_ckpt and can_skip else 0
    walltime_left = float(training.get("walltime_min_seconds_left", 300.0))
    profiler = tr.Profiler(config)
    obs = telemetry.observer()
    if obs is not None and epoch_start > 0:
        # a resumed run's first epoch captures its graphs anew
        obs.warmup_phase = max(obs.warmup_phase, epoch_start + 1)

    def loop_state():
        return _loop_state(hist, best_val, bad_epochs, scheduler)

    def branch_steps(step: int):
        """The per-branch cursors a multibranch save records (lockstep)."""
        return [int(step)] * n_branches if multibranch else None

    next_epoch = epoch_start
    for epoch in range(epoch_start, num_epoch):
        next_epoch = epoch + 1
        t0 = time.time()
        captures = graphs.captures if graphs is not None else 0
        profiler.on_epoch_start(epoch)
        if telemetry.active():
            telemetry.note_epoch(epoch, lr=get_learning_rate(state.optimizer))
        elif telemetry.observer() is not None:
            telemetry.note_epoch(epoch)
        train_loader.set_epoch(epoch)
        if monitor is not None:
            monitor.note_epoch(epoch)
        acc0, step0 = None, 0
        if epoch == epoch_start and resume_step > 0:
            train_loader.skip_to(resume_cursor)
            acc0, step0 = resume_acc, resume_step
        while True:
            step_hook = None
            if interval > 0:
                last = {"step": step0}

                def step_hook(st, steps_done, acc, _epoch=epoch, _last=last):
                    if steps_done - _last["step"] >= interval:
                        _last["step"] = steps_done
                        writer.save(st, kind="auto", epoch=_epoch, step=steps_done,
                                    acc=acc, loop=loop_state(),
                                    branch_steps=branch_steps(steps_done))

            try:
                state, train_loss, train_tasks = _run_epoch(
                    train_step, state, train_loader, train=True, acc0=acc0, step0=step0,
                    step_hook=step_hook, guard=monitor)
                break
            except guard_mod.GuardRollback as rb:
                state, acc0, step0 = _guard_rollback(rb, monitor, state, epoch, train_loader,
                                                     writer, scheduler, verbosity)
        _, val_loss, val_tasks = _run_epoch(eval_step, state, val_loader, train=False)
        _, test_loss, test_tasks = _run_epoch(eval_step, state, test_loader, train=False)
        lr = get_learning_rate(state.optimizer)
        new_lr = scheduler.step(val_loss, lr)
        if new_lr != lr:
            set_learning_rate(state.optimizer, new_lr)
        profiler.on_epoch_end(epoch)
        hist.train_loss.append(train_loss)
        hist.val_loss.append(val_loss)
        hist.test_loss.append(test_loss)
        hist.train_tasks.append(train_tasks)
        hist.val_tasks.append(val_tasks)
        hist.test_tasks.append(test_tasks)
        hist.lr.append(new_lr)
        hist.epoch_seconds.append(time.time() - t0)
        hist.epoch_captures.append(
            (graphs.captures if graphs is not None else 0) - captures)
        if telemetry.active():
            # the exact floats History holds (JSON round-trips them)
            telemetry.emit({
                "t": "epoch",
                "epoch": epoch,
                "train_loss": train_loss,
                "val_loss": val_loss,
                "test_loss": test_loss,
                "train_tasks": np.asarray(train_tasks).reshape(-1).tolist(),
                "lr": new_lr,
                "seconds": hist.epoch_seconds[-1],
            })
            telemetry.emit_memory("epoch", epoch=epoch)
        print_distributed(
            verbosity,
            1,
            f"Epoch {epoch:4d} | train {train_loss:.6f} | val {val_loss:.6f} "
            f"| test {test_loss:.6f} | lr {new_lr:.2e} "
            f"| {time.time() - t0:.2f}s",
        )
        improved = val_loss < best_val
        saved = False
        if improved:
            best_val = val_loss
            bad_epochs = 0
            if use_ckpt and epoch >= warmup:
                writer.save(state, kind="epoch", epoch=epoch + 1, step=0, label_epoch=epoch,
                            loop=loop_state(), branch_steps=branch_steps(0))
                saved = True
        else:
            bad_epochs += 1
            if early_stop and bad_epochs >= patience:
                print_distributed(verbosity, 1, f"Early stopping at epoch {epoch}")
                break
        if interval > 0 and not saved:
            # the epoch's end as a cursor: a kill early in the next epoch
            # keeps this epoch's bookkeeping
            writer.save(state, kind="auto", epoch=epoch + 1, step=0, loop=loop_state(),
                        branch_steps=branch_steps(0))
        if not check_remaining(walltime_left):
            print_distributed(verbosity, 1,
                              f"Stopping at epoch {epoch}: job walltime nearly exhausted")
            if use_ckpt:
                writer.save(state, kind="epoch", epoch=epoch + 1, step=0, label_epoch=epoch,
                            loop=loop_state(), branch_steps=branch_steps(0))
            break
    telemetry.end_of_training()
    recal = bn_recalibration_epochs(training)
    if recal and plan is not None and plan.scheme != "single":
        print_distributed(
            verbosity, 0,
            "Training.bn_recalibration ignored: supported on the single scheme only "
            "(dp-stacked batches have no sequential-EMA path)",
        )
        recal = 0
    if recal:
        state = recalibrate_batch_stats(
            model, state, train_loader if recal_loader is None else recal_loader,
            device=device, compute_dtype=compute_dtype, epochs=recal,
        )
    if writer is not None:
        writer.save(state, kind="final", epoch=next_epoch, step=0, loop=loop_state(),
                    branch_steps=branch_steps(0))
    return state, hist


def _gather_slots(per_batch: List[List[np.ndarray]], plan) -> List[List[np.ndarray]]:
    """Every rank's per-batch collections, in the JAX package's order:
    node by node, batch by batch, and the node's slots in order within a
    batch (its ``[D, ...]`` device axis flattened into the samples, then
    the processes' sets concatenated). The ranks of one slot hold the
    same rows (HSDP), so each slot's first rank speaks for it."""
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel.runtime import process_count

    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, per_batch)
    k = plan.mesh.fsdp
    n = plan.mesh.data // process_count()
    out: List[List[np.ndarray]] = [[] for _ in per_batch]
    for p in range(process_count()):
        for t in range(len(per_batch[0]) if per_batch else 0):
            for slot in range(p * n, (p + 1) * n):
                for h, rows in enumerate(gathered[slot * k]):
                    out[h].append(rows[t])
    return out


def test(
    model: torch.nn.Module,
    cfg: ModelConfig,
    state: TrainState,
    loader,
    *,
    device: torch.device,
    compute_dtype: torch.dtype = torch.float32,
    compute_grad_energy: bool = False,
    plan=None,
    gather: bool = True,
) -> Tuple[float, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """A full test pass collecting per-sample true/pred per head. Returns
    (error, per-task error, trues, preds); trues/preds hold one
    ``[num_samples_or_nodes, dim]`` array per head, padding removed (with
    ``compute_grad_energy``: graph energies [G, 1] and forces [N, 3]).
    Each batch's step runs through ``state.graphs`` where there is one
    (its outputs are fetched right after the replay); the loss sums stay
    on the device until the end, and only the per-sample collections
    cross to the host per batch. Under a dp ``plan`` the loader gives
    this rank's slot (``parallel/dp.DPLoader``), the loss is the dp eval
    step's, and with ``gather`` every rank returns every slot's samples
    (``_gather_slots``)."""
    red = None
    if plan is not None and plan.scheme == "dp" and plan.mesh is not None:
        from hydragnn_tpu_torch.parallel.dp import Reduction

        red = Reduction(model, plan)
    run = _steps_fn(_eval_body(model, cfg, compute_dtype, True, compute_grad_energy, red))
    key = _step_key(red, "test", compute_dtype)
    n_coll = 2 if compute_grad_energy else len(cfg.heads)
    acc = None
    trues: List[List[np.ndarray]] = [[] for _ in range(n_coll)]
    preds: List[List[np.ndarray]] = [[] for _ in range(n_coll)]
    for batch in loader:
        tots, tasks, gs, *outputs = _dispatch(run, state.graphs, key, [batch], device)
        acc = fold_step_metrics(acc, tots, tasks, gs)
        gm = np.asarray(batch.graph_mask)
        nm = np.asarray(batch.node_mask)
        if compute_grad_energy:
            ge, forces = (o.float().cpu().numpy() for o in outputs)
            trues[0].append(np.asarray(batch.energy)[gm, None])
            preds[0].append(ge[gm])
            trues[1].append(np.asarray(batch.forces)[nm])
            preds[1].append(forces[nm])
            continue
        for hi, (level, start, end) in enumerate(cfg.head_offsets()):
            out = outputs[hi][:, : cfg.heads[hi].dim].float().cpu().numpy()
            if level == "graph":
                y, m = np.asarray(batch.y_graph)[:, start:end], gm
            else:
                y, m = np.asarray(batch.y_node)[:, start:end], nm
            trues[hi].append(y[m])
            preds[hi].append(out[m])
    pstats = pipeline_stats(loader)
    if pstats is not None:
        pstats.flush_to_tracer()
    error, tasks_avg =(0.0, np.zeros(1)) if acc is None else _fetch_epoch(*acc)
    if red is not None and gather and red.active:
        both = _gather_slots(trues + preds, plan)
        trues, preds = both[:n_coll], both[n_coll:]
    return (
        error,
        tasks_avg,
        [np.concatenate(t, axis=0) for t in trues],
        [np.concatenate(p, axis=0) for p in preds],
    )
