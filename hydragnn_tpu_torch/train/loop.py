"""Training / validation / test loops.

Counterpart of ``hydragnn_tpu/train/loop.py``: ``make_train_step``,
``make_eval_step``, ``fold_step_metrics``, ``make_superstep_fn``,
``superstep_task_count``, ``History``, ``train_validate_test`` (the
serial feed, with superstep groups) and ``test``. An epoch runs each
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

Checkpoints (``utils/checkpoint.py``): with ``Training.Checkpoint`` on,
every epoch that improves the validation loss (from epoch
``checkpoint_warmup`` on) saves its epoch file and ``latest``, keeping
the newest ``checkpoint_keep`` (5); every run saves ``latest`` at its
end, after the end-of-training batch-norm recalibration
(``recalibrate_batch_stats``, ``Training.bn_recalibration``).

Under a dp or multibranch ``plan`` (``parallel/runtime.ParallelPlan``)
the epoch loop runs ``parallel/dp.make_dp_superstep_fn``'s steps (the
JAX loop's scheme dispatch, ``build_steps``): each rank's step on its
slot, reduced over the ranks, so every rank holds the same history; the
end-of-training batch-norm recalibration is skipped there with a
message, as in the JAX package, and ``test`` gathers the slots' per-
sample outputs in the JAX package's order.

Not ported yet, and refused by the runner: resume (``continue``), the
divergence guard, the pipeline feed and telemetry (ROADMAP Queue 1
items 12, 10, 13).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.data.loader import MacroBatch
from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.models.spec import ModelConfig
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
from hydragnn_tpu_torch.utils.checkpoint import checkpoint_settings, save_checkpoint
from hydragnn_tpu_torch.utils.print_utils import print_distributed


def _graph_count(batch) -> torch.Tensor:
    return batch.graph_mask.sum().to(torch.float32)


def _train_body(model, optimizer, cfg, compute_dtype, clip_norm, compute_grad_energy,
                red=None, *, clip_groups: bool = False):
    """``body(batch) -> (loss, per_task, n_graphs)``: one optimizer step
    on a batch already on the model's device, with no host sync (so it
    can be captured). The gradients stay in ``.grad`` until the next
    step. With ``red`` (a ``parallel/dp.Reduction``) it is one rank's
    step of a dp or multibranch plan: the loss weighted before the
    backward; the gradients, running statistics and loss terms reduced
    over the ranks after it; ``n_graphs`` the global count.
    ``clip_groups`` clips each optimizer group on its own (the dual
    optimizer's two optax chains)."""
    params = list(model.parameters())
    scale = float(red.n_slots) if red is not None and red.fsdp else 1.0

    def body(batch):
        b = cast_batch(batch, compute_dtype)
        model.train()
        optimizer.zero_grad(set_to_none=True)
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
        # A parameter the loss does not reach takes a zero gradient, as in
        # optax, so AdamW's weight decay still moves it.
        for p in live:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if red is not None:
            tot, tasks = red.reduce_train(live, tot, tasks, w.reshape(()))
        if clip_norm > 0:
            groups = [g["params"] for g in optimizer.param_groups] if clip_groups else [live]
            for group in groups:
                clip_by_global_norm_(group, clip_norm)
        optimizer.step()
        return tot.detach(), tasks.detach(), n_graphs.reshape(())

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


def make_train_step(
    model: torch.nn.Module,
    optimizer: OptaxOptimizer,
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
    clip_norm: float = 0.0,
    compute_grad_energy: bool = False,
    red=None,
    clip_groups: bool = False,
) -> Callable:
    """``step(state, batch) -> (state, loss, per_task)``: one eager
    optimizer step on a batch already on the model's device. The losses
    come back as device tensors (no host sync); the gradients stay in
    ``.grad`` until the next step. ``compute_grad_energy`` trains on the
    MLIP energy + force loss, whose backward differentiates the force
    pass. ``red`` and ``clip_groups``: ``_train_body``."""
    body = _train_body(model, optimizer, cfg, compute_dtype, clip_norm, compute_grad_energy,
                       red, clip_groups=clip_groups)

    def step(state: TrainState, batch):
        tot, tasks, _ = body(batch)
        state.step += 1
        return state, tot, tasks

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


def _steps_fn(body) -> Callable:
    """K steps of ``body`` over K device batches: ``(loss [K], per_task
    [K, T], graphs [K], *each step's extra outputs)``. The graph count is
    the body's (the global one under dp)."""

    def run(batches):
        rows = [body(b) for b in batches]
        out = tuple(torch.stack([r[i] for r in rows]) for i in range(3))
        return out + tuple(x for r in rows for x in r[3:])

    return run


def _dispatch(run, graphs, key, batches, device):
    """``run`` over host batches: through the graph cache on the card,
    eagerly on ``device`` otherwise."""
    if graphs is None:
        return run([b.to(device) for b in batches])
    return graphs.run(key + (len(batches),) + _spec_key(batches[0]), run, batches)


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
    dispatch gives the bits of K single-step dispatches."""
    if train:
        body = _train_body(model, optimizer, cfg, compute_dtype, clip_norm,
                           compute_grad_energy, red, clip_groups=clip_groups)
    else:
        body = _eval_body(model, cfg, compute_dtype, False, compute_grad_energy, red)
    run = _steps_fn(body)
    key = _step_key(red, "train" if train else "eval", compute_dtype)

    def superstep(state, acc, batches):
        tots, tasks, gs = _dispatch(run, graphs, key, batches, device)
        acc = fold_step_metrics(acc, tots, tasks, gs)
        if train:
            state.step += len(batches)
            return state, acc
        return acc

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
    vals = torch.cat(
        [loss_sum.reshape(1).double(), tasks_sum.reshape(-1).double(),
         n_graphs.reshape(1).double()]
    ).cpu().numpy()
    denom = max(float(vals[-1]), 1.0)
    return float(vals[0]) / denom, vals[1:-1] / denom


def _run_epoch(superstep, state, loader, *, train: bool):
    """One pass over the loader: each delivery (a batch, or a
    ``MacroBatch`` of K) is one superstep dispatch; the weighted partial
    sums accumulate on the device and are fetched once at the end."""
    acc = None
    for item in loader:
        batches = item.batches if isinstance(item, MacroBatch) else [item]
        if train:
            state, acc = superstep(state, acc, batches)
        else:
            acc = superstep(state, acc, batches)
    if acc is None:
        return state, 0.0, np.zeros(1)
    loss, tasks = _fetch_epoch(*acc)
    return state, loss, tasks


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
    log_name: Optional[str] = None,
    recal_loader=None,
    plan=None,
) -> Tuple[TrainState, History]:
    """The epoch loop: train, validate, test, step the plateau scheduler
    on the validation loss, stop early after ``patience`` epochs without
    improvement when ``EarlyStopping`` is set. The loaders may deliver
    ``MacroBatch`` groups (``data/loader.SuperstepLoader``); the steps
    run through ``state.graphs`` where the run has one (on the card).
    With a ``log_name`` the run saves checkpoints under
    ``./logs/<log_name>/`` (module docstring); ``recal_loader`` is the
    feed of the end-of-training batch-norm recalibration (the train
    loader when None). ``plan`` selects the dp or multibranch steps
    (module docstring)."""
    training = config["NeuralNetwork"]["Training"]
    num_epoch = int(training.get("num_epoch", 1))
    patience = int(training.get("patience", 10))
    early_stop = bool(training.get("EarlyStopping", False))
    save_on_best = log_name is not None and checkpoint_settings(training).enabled
    warmup = int(training.get("checkpoint_warmup", 0))
    keep = int(training.get("checkpoint_keep", 5))
    graphs = state.graphs
    kw = dict(compute_dtype=compute_dtype, compute_grad_energy=cfg.enable_interatomic_potential,
              device=device, graphs=graphs)
    if plan is None or plan.scheme == "single":
        train_step = make_superstep_fn(model, state.optimizer, cfg, train=True,
                                       clip_norm=clip_norm, **kw)
        eval_step = make_superstep_fn(model, None, cfg, train=False, **kw)
    else:
        from hydragnn_tpu_torch.parallel.dp import make_dp_superstep_fn
        from hydragnn_tpu_torch.parallel.multibranch import decoder_grad_scales

        scales = (decoder_grad_scales(model, cfg, plan.data_parallel_size,
                                      plan.devices_per_branch)
                  if plan.scheme == "multibranch" else None)
        train_step = make_dp_superstep_fn(model, state.optimizer, cfg, plan, train=True,
                                          clip_norm=clip_norm, kind=plan.scheme,
                                          decoder_scales=scales, **kw)
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
    for epoch in range(num_epoch):
        t0 = time.time()
        captures = graphs.captures if graphs is not None else 0
        train_loader.set_epoch(epoch)
        state, train_loss, train_tasks = _run_epoch(
            train_step, state, train_loader, train=True
        )
        _, val_loss, val_tasks = _run_epoch(eval_step, state, val_loader, train=False)
        _, test_loss, test_tasks = _run_epoch(eval_step, state, test_loader, train=False)
        lr = get_learning_rate(state.optimizer)
        new_lr = scheduler.step(val_loss, lr)
        if new_lr != lr:
            set_learning_rate(state.optimizer, new_lr)
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
        print_distributed(
            verbosity,
            1,
            f"Epoch {epoch:4d} | train {train_loss:.6f} | val {val_loss:.6f} "
            f"| test {test_loss:.6f} | lr {new_lr:.2e} "
            f"| {time.time() - t0:.2f}s",
        )
        if val_loss < best_val:
            best_val = val_loss
            bad_epochs = 0
            if save_on_best and epoch >= warmup:
                save_checkpoint(log_name, state, epoch=epoch, keep=keep)
        else:
            bad_epochs += 1
            if early_stop and bad_epochs >= patience:
                print_distributed(verbosity, 1, f"Early stopping at epoch {epoch}")
                break
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
    if log_name is not None:
        save_checkpoint(log_name, state)
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
    error, tasks_avg = (0.0, np.zeros(1)) if acc is None else _fetch_epoch(*acc)
    if red is not None and gather and red.active:
        both = _gather_slots(trues + preds, plan)
        trues, preds = both[:n_coll], both[n_coll:]
    return (
        error,
        tasks_avg,
        [np.concatenate(t, axis=0) for t in trues],
        [np.concatenate(p, axis=0) for p in preds],
    )
