"""Training / validation / test loops.

Counterpart of ``hydragnn_tpu/train/loop.py``: ``make_train_step``,
``make_eval_step``, ``History``, ``train_validate_test`` (the serial
feed) and ``test``. An epoch runs each batch's step on the device and
keeps the graph-weighted loss sums there; the host fetches them once at
the end of the epoch (the JAX loop's discipline), never per step. The
plateau scheduler steps on the validation loss and early stopping
follows ``Training.EarlyStopping``/``patience``, as in the JAX loop.
With ``compute_grad_energy`` (an interatomic potential) the steps take
the energy + force loss of ``train/mlip.py`` (three per-task losses:
energy, energy per atom, force), and the collecting test pass returns
[graph energies, forces].

Checkpoints (``utils/checkpoint.py``): with ``Training.Checkpoint`` on,
every epoch that improves the validation loss (from epoch
``checkpoint_warmup`` on) saves its epoch file and ``latest``, keeping
the newest ``checkpoint_keep`` (5); every run saves ``latest`` at its
end, after the end-of-training batch-norm recalibration
(``recalibrate_batch_stats``, ``Training.bn_recalibration``).

Not ported yet, and refused by the runner: resume (``continue``), the
divergence guard, supersteps, the pipeline feed and telemetry (ROADMAP
Queue 1 items 12, 10, 13).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.train.losses import multihead_loss
from hydragnn_tpu_torch.train.mlip import (
    energy_and_forces,
    energy_force_loss,
    energy_force_loss_terms,
)
from hydragnn_tpu_torch.train.optimizer import (
    ReduceLROnPlateau,
    clip_by_global_norm_,
    get_learning_rate,
    set_learning_rate,
)
from hydragnn_tpu_torch.train.state import TrainState, cast_batch
from hydragnn_tpu_torch.utils.checkpoint import checkpoint_settings, save_checkpoint
from hydragnn_tpu_torch.utils.print_utils import print_distributed


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
    clip_norm: float = 0.0,
    compute_grad_energy: bool = False,
) -> Callable:
    """``step(state, batch) -> (state, loss, per_task)``: one optimizer
    step on a batch already on the model's device. The losses come back
    as device tensors (no host sync); the gradients stay in ``.grad``
    until the next step. ``compute_grad_energy`` trains on the MLIP
    energy + force loss, whose backward differentiates the force pass."""
    params = list(model.parameters())

    def step(state: TrainState, batch):
        b = cast_batch(batch, compute_dtype)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if compute_grad_energy:
            tot, tasks = energy_force_loss(model, b, cfg)
        else:
            tot, tasks = multihead_loss(model(b), b, cfg)
        tot.backward()
        # A parameter the loss does not reach takes a zero gradient, as in
        # optax, so AdamW's weight decay still moves it.
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if clip_norm > 0:
            clip_by_global_norm_(params, clip_norm)
        optimizer.step()
        state.step += 1
        return state, tot.detach(), tasks.detach()

    return step


def make_eval_step(
    model: torch.nn.Module,
    cfg: ModelConfig,
    compute_dtype: torch.dtype = torch.float32,
    collect_outputs: bool = False,
    compute_grad_energy: bool = False,
) -> Callable:
    """``step(state, batch) -> (loss, per_task[, outputs])`` in eval mode
    without parameter gradients. With ``compute_grad_energy`` the forces
    take a gradient with respect to the positions only (no graph is
    kept), and the outputs are [graph energies [G, 1], forces [N, 3]]."""

    def step(state: TrainState, batch):
        del state
        b = cast_batch(batch, compute_dtype)
        model.eval()
        if compute_grad_energy:
            with torch.enable_grad():
                ge, forces = energy_and_forces(model, b, cfg, create_graph=False)
            ge, forces = ge.detach(), forces.detach()
            tot, tasks = energy_force_loss_terms(ge, forces, b, cfg)
            if collect_outputs:
                return tot, tasks, [ge[:, None], forces]
            return tot, tasks
        with torch.no_grad():
            outputs = model(b)
            tot, tasks = multihead_loss(outputs, b, cfg)
        if collect_outputs:
            return tot, tasks, list(outputs)
        return tot, tasks

    return step


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


def _fetch_epoch(loss_sum, tasks_sum, n_graphs) -> Tuple[float, np.ndarray]:
    """The one host fetch of an epoch: (mean loss, mean per-task)."""
    vals = torch.cat(
        [loss_sum.reshape(1).double(), tasks_sum.reshape(-1).double(),
         n_graphs.reshape(1).double()]
    ).cpu().numpy()
    denom = max(float(vals[-1]), 1.0)
    return float(vals[0]) / denom, vals[1:-1] / denom


def _run_epoch(step_fn, state, loader, *, train: bool, device: torch.device):
    """One pass over the loader; weighted partial sums accumulate on the
    device and are fetched once at the end."""
    loss_sum = tasks_sum = n_graphs = None
    for batch in loader:
        batch = batch.to(device)
        ng = batch.graph_mask.sum().to(torch.float32)
        if train:
            state, loss, tasks = step_fn(state, batch)
        else:
            loss, tasks = step_fn(state, batch)
        if loss_sum is None:
            loss_sum, tasks_sum, n_graphs = loss * ng, tasks * ng, ng
        else:
            loss_sum = loss_sum + loss * ng
            tasks_sum = tasks_sum + tasks * ng
            n_graphs = n_graphs + ng
    if loss_sum is None:
        return state, 0.0, np.zeros(1)
    loss, tasks = _fetch_epoch(loss_sum, tasks_sum, n_graphs)
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
    for _ in range(int(epochs)):
        for batch in loader:
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
) -> Tuple[TrainState, History]:
    """The epoch loop: train, validate, test, step the plateau scheduler
    on the validation loss, stop early after ``patience`` epochs without
    improvement when ``EarlyStopping`` is set. With a ``log_name`` the
    run saves checkpoints under ``./logs/<log_name>/`` (module
    docstring); ``recal_loader`` is the feed of the end-of-training
    batch-norm recalibration (the train loader when None)."""
    training = config["NeuralNetwork"]["Training"]
    num_epoch = int(training.get("num_epoch", 1))
    patience = int(training.get("patience", 10))
    early_stop = bool(training.get("EarlyStopping", False))
    save_on_best = log_name is not None and checkpoint_settings(training).enabled
    warmup = int(training.get("checkpoint_warmup", 0))
    keep = int(training.get("checkpoint_keep", 5))
    mlip = cfg.enable_interatomic_potential
    train_step = make_train_step(
        model, state.optimizer, cfg, compute_dtype, clip_norm=clip_norm,
        compute_grad_energy=mlip,
    )
    eval_step = make_eval_step(model, cfg, compute_dtype, compute_grad_energy=mlip)
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
        train_loader.set_epoch(epoch)
        state, train_loss, train_tasks = _run_epoch(
            train_step, state, train_loader, train=True, device=device
        )
        _, val_loss, val_tasks = _run_epoch(
            eval_step, state, val_loader, train=False, device=device
        )
        _, test_loss, test_tasks = _run_epoch(
            eval_step, state, test_loader, train=False, device=device
        )
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
    if recal:
        state = recalibrate_batch_stats(
            model, state, train_loader if recal_loader is None else recal_loader,
            device=device, compute_dtype=compute_dtype, epochs=recal,
        )
    if log_name is not None:
        save_checkpoint(log_name, state)
    return state, hist


def test(
    model: torch.nn.Module,
    cfg: ModelConfig,
    state: TrainState,
    loader,
    *,
    device: torch.device,
    compute_dtype: torch.dtype = torch.float32,
    compute_grad_energy: bool = False,
) -> Tuple[float, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """A full test pass collecting per-sample true/pred per head. Returns
    (error, per-task error, trues, preds); trues/preds hold one
    ``[num_samples_or_nodes, dim]`` array per head, padding removed (with
    ``compute_grad_energy``: graph energies [G, 1] and forces [N, 3]).
    The loss sums stay on the device until the end; only the per-sample
    collections cross to the host per batch."""
    eval_step = make_eval_step(
        model, cfg, compute_dtype, collect_outputs=True,
        compute_grad_energy=compute_grad_energy,
    )
    n_coll = 2 if compute_grad_energy else len(cfg.heads)
    loss_sum = tasks_sum = ng_sum = None
    trues: List[List[np.ndarray]] = [[] for _ in range(n_coll)]
    preds: List[List[np.ndarray]] = [[] for _ in range(n_coll)]
    for batch in loader:
        batch = batch.to(device)
        loss, tasks, outputs = eval_step(state, batch)
        ng = batch.graph_mask.sum()
        ngf = ng.to(torch.float32)
        if loss_sum is None:
            loss_sum, tasks_sum, ng_sum = loss * ngf, tasks * ngf, ng
        else:
            loss_sum = loss_sum + loss * ngf
            tasks_sum = tasks_sum + tasks * ngf
            ng_sum = ng_sum + ng
        gm = batch.graph_mask.cpu().numpy()
        nm = batch.node_mask.cpu().numpy()
        if compute_grad_energy:
            ge, forces = (o.float().cpu().numpy() for o in outputs)
            trues[0].append(batch.energy.cpu().numpy()[gm, None])
            preds[0].append(ge[gm])
            trues[1].append(batch.forces.cpu().numpy()[nm])
            preds[1].append(forces[nm])
            continue
        for hi, (level, start, end) in enumerate(cfg.head_offsets()):
            out = outputs[hi][:, : cfg.heads[hi].dim].float().cpu().numpy()
            if level == "graph":
                y, m = batch.y_graph[:, start:end].cpu().numpy(), gm
            else:
                y, m = batch.y_node[:, start:end].cpu().numpy(), nm
            trues[hi].append(y[m])
            preds[hi].append(out[m])
    error, tasks_avg = (
        (0.0, np.zeros(1)) if loss_sum is None
        else _fetch_epoch(loss_sum, tasks_sum, ng_sum)
    )
    return (
        error,
        tasks_avg,
        [np.concatenate(t, axis=0) for t in trues],
        [np.concatenate(p, axis=0) for p in preds],
    )
