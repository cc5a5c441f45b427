"""Data-parallel (and ZeRO/FSDP) training over the ranks.

Counterpart of ``hydragnn_tpu/parallel/dp.py``. The JAX package vmaps
one step over a ``[D, ...]`` stack of sub-batches and lets GSPMD insert
the gradient all-reduce; each rank of the port runs the single scheme's
step on its own slot of the step (``DPLoader``) with the collectives
written out (``Reduction``):

- the loss is the mean over every real graph of the global batch: the
  ranks all-reduce their real-graph counts first, and each rank's loss
  is scaled by ``n_graphs_r / sum(n_graphs)`` before its backward
  (``_device_weighted_mean``'s weights), so the gradients are *summed*
  (DDP's and FSDP's default equal-rank mean differ whenever the slots
  hold different numbers of real graphs, as on every packed epoch and
  every remainder step); a fully masked slot (``_masked_out``) weighs 0
  and adds an exact zero;
- the gradients, every ``MaskedBatchNorm``'s running statistics and the
  weighted loss terms travel in one flat buffer, all-reduced in place
  (a static address, so a captured step holds its NCCL all-reduce); the
  running statistics become the mean over the slots of each slot's
  update, fully masked slots included, as ``jnp.mean`` over the device
  axis gives them (no SyncBatchNorm: each slot normalizes with its own
  batch statistics);
- under ``plan.fsdp`` the model is sharded with FSDP2 ``fully_shard``
  (``replicate_state``): over every rank for ZeRO, over the
  ``(replicate, shard)`` grid for HSDP, whose ``fsdp`` ranks of a row
  share one slot. FSDP2's reduce-scatter divides by the world size, so
  the loss is scaled by the slot count as well; the optimizer steps the
  DTensor shards. These steps run eagerly (``capturable``).

No ``DistributedDataParallel``: its reducer averages where the JAX
package weights, and its autograd hooks do not belong in a replayed
graph. K1/K2 run inside every rank's step wherever the single scheme
runs them: the port attaches the segment plan under dp too (the JAX
package does not, because its planned ``pallas_call`` does not run under
the step's ``vmap``; the port has no ``vmap``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hydragnn_tpu_torch.data.graph import GraphBatch
from hydragnn_tpu_torch.data.loader import MacroBatch
from hydragnn_tpu_torch.models.layers import MaskedBatchNorm
from hydragnn_tpu_torch.train.loop import make_eval_step, make_superstep_fn, make_train_step
from hydragnn_tpu_torch.utils import telemetry


def replicate_state(model: torch.nn.Module, plan, device) -> torch.nn.Module:
    """Place ``model`` for the plan (the JAX package's
    ``replicate_state``/``param_sharding_spec``): every parameter and
    buffer broadcast from rank 0, then, with ``plan.fsdp``, the model
    sharded by FSDP2 over ``plan.mesh.device_mesh`` (each parameter's
    dim 0 split over the sharding ranks; the optimizer built afterwards
    keeps its state in the same DTensor shards). Parameters stay whole
    through a step (``reshard_after_forward=False``; the MLIP loss's
    force pass differentiates twice) and are resharded by the step
    itself."""
    if plan.mesh is None or not plan.mesh.active():
        return model
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.is_contiguous():
                dist.broadcast(t.data, src=0)
            else:  # a strided view (MACE keeps some): broadcast a copy
                c = t.data.contiguous()
                dist.broadcast(c, src=0)
                t.data.copy_(c)
    if plan.fsdp:
        from torch.distributed.fsdp import fully_shard

        fully_shard(model, mesh=plan.mesh.device_mesh(torch.device(device).type),
                    reshard_after_forward=False)
        model.set_reshard_after_backward(False)
    return model


def capturable(plan) -> bool:
    """Whether this plan's steps can be CUDA-graph captured: dp or
    multibranch (one step body, ``train/loop._train_body`` with a
    ``Reduction``) over NCCL without FSDP2 (gloo's collectives run on the
    host; FSDP2's hooks allocate and free per step). A decision per
    scheme, printed by the runner, never a capture failure retried."""
    if plan is None or plan.mesh is None or not plan.mesh.active():
        return True
    return not plan.fsdp and dist.get_backend() == dist.Backend.NCCL


def eager_reason(plan) -> Optional[str]:
    """Why ``capturable(plan)`` is False (None when it is True)."""
    if capturable(plan):
        return None
    if plan.fsdp:
        return "FSDP2's unshard/reshard hooks allocate per step"
    return f"{dist.get_backend()}'s collectives cannot be captured"


class Reduction:
    """The collectives of one rank's step under a plan (module
    docstring). ``kind`` is ``"dp"`` (graph-weighted) or
    ``"multibranch"`` (the equal mean over slots, then each branch's
    decoder gradients times D / D_b: ``parallel/multibranch``)."""

    def __init__(self, model: torch.nn.Module, plan, kind: str = "dp",
                 decoder_scales: Optional[dict] = None):
        self.model = model
        self.kind = kind
        # an FSDP plan's model as run_prediction may build it, unsharded
        self.fsdp = bool(plan.fsdp) and hasattr(model, "reshard")
        self.n_slots = plan.mesh.data
        self.active = plan.mesh.active()
        self.world = dist.get_world_size() if self.active else 1
        self.group = plan.mesh.slot_group() if self.active else None
        self.bns = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
        self.decoder_scales = decoder_scales or {}
        self._flat: Optional[torch.Tensor] = None

    def _all_reduce(self, t: torch.Tensor, group=None) -> torch.Tensor:
        if self.active:
            dist.all_reduce(t, group=group)
        return t

    def weight(self, batch) -> tuple:
        """``(w, n_graphs)`` of this slot before its backward: dp's
        ``n_graphs_r / max(sum, 1)`` and the global count, or
        multibranch's ``1 / D`` and the global count."""
        own = batch.graph_mask.sum().to(torch.float32).reshape(1)
        total = self._all_reduce(own.clone(), self.group)
        if self.kind == "multibranch":
            return torch.full_like(own, 1.0 / self.n_slots), total
        return own / torch.clamp(total, min=1.0), total

    def _bn_views(self) -> List[torch.Tensor]:
        return [t for m in self.bns for t in (m.mean, m.var)]

    def after_forward(self) -> None:
        """Reshard FSDP2's parameters (a step leaves them sharded)."""
        if self.fsdp:
            self.model.reshard()

    def reduce_train(self, params, tot, tasks, w) -> tuple:
        """After the backward: sum the gradients (unless FSDP2 did),
        average the running statistics, sum the weighted loss terms;
        returns the reduced ``(loss, per_task)``. The multibranch
        rescale follows in ``rescale``."""
        grads = [] if self.fsdp else [p.grad for p in params]
        bufs = self._bn_views()
        terms = [(tot.detach() * w).reshape(1), (tasks.detach() * w).reshape(-1)]
        parts = [g.reshape(-1) for g in grads] + [b.reshape(-1) for b in bufs]
        dtype = params[0].dtype if params else torch.float32
        n = sum(p.numel() for p in parts) + sum(t.numel() for t in terms)
        if self._flat is None or self._flat.numel() != n:
            self._flat = torch.empty(n, dtype=dtype, device=tot.device)
        flat = self._flat
        torch.cat([p.to(dtype) for p in parts] + [t.to(dtype) for t in terms], out=flat)
        # FSDP's slot group differs from the world (HSDP): the gradient
        # went through its reduce-scatter, so the loss terms reduce over
        # the slots and the statistics over the world.
        if self.fsdp and self.group is not None:
            nb = sum(b.numel() for b in bufs)
            self._all_reduce(flat[:nb])
            self._all_reduce(flat[nb:], self.group)
        else:
            self._all_reduce(flat)
        off = 0
        for p, g in zip(params, grads):
            p.grad = flat[off : off + g.numel()].view_as(g)
            off += g.numel()
        per_stat = self.world if self.fsdp else self.n_slots
        with torch.no_grad():
            for b in bufs:
                b.copy_(flat[off : off + b.numel()].view_as(b) / per_stat)
                off += b.numel()
        # copies: the next step rewrites the buffer
        loss = flat[off].to(tot.dtype, copy=True)
        per_task = flat[off + 1 :].view_as(tasks).to(tasks.dtype, copy=True)
        return loss, per_task

    def rescale(self) -> None:
        """After ``reduce_train``: each branch decoder's gradients times
        D / D_b (multibranch; nothing otherwise)."""
        if self.decoder_scales:
            with torch.no_grad():
                for p, s in self.decoder_scales.items():
                    p.grad.mul_(s)

    def reduce_eval(self, tot, tasks, w) -> tuple:
        """The graph-weighted eval loss over the slots."""
        terms = torch.cat([(tot * w).reshape(1), (tasks * w).reshape(-1)])
        self._all_reduce(terms, self.group)
        return terms[0], terms[1:].view_as(tasks)


def make_dp_train_step(model, optimizer, cfg, plan, compute_dtype=torch.float32,
                       clip_norm: float = 0.0, compute_grad_energy: bool = False) -> Callable:
    """``step(state, batch) -> (state, loss, per_task)``: one eager dp
    step on this rank's slot (a batch on the model's device); the loss
    is the graph-weighted mean over the slots."""
    return make_train_step(model, optimizer, cfg, compute_dtype, clip_norm,
                           compute_grad_energy, red=Reduction(model, plan))


def make_dp_eval_step(model, cfg, plan, compute_dtype=torch.float32,
                      compute_grad_energy: bool = False,
                      collect_outputs: bool = False) -> Callable:
    """``step(state, batch) -> (loss, per_task[, outputs])``: the dp eval
    step on this rank's slot; ``outputs`` (with ``collect_outputs``) are
    the slot's own head outputs, which ``train/loop.test`` gathers."""
    return make_eval_step(model, cfg, compute_dtype, collect_outputs, compute_grad_energy,
                          red=Reduction(model, plan))


def make_dp_superstep_fn(model, optimizer, cfg, plan, *, train: bool = True,
                         kind: str = "dp", decoder_scales=None, **kw) -> Callable:
    """The dp superstep: ``train/loop.make_superstep_fn``'s K steps (its
    keywords in ``kw``) as this rank's steps of the plan; on the card a
    captured graph of K steps holding its all-reduces (where
    ``capturable``), else K eager steps. ``kind="multibranch"`` runs the
    multibranch train step (``parallel/multibranch``)."""
    red = Reduction(model, plan, kind=kind if train else "dp",
                    decoder_scales=decoder_scales if train else None)
    return make_superstep_fn(model, optimizer, cfg, train=train, red=red,
                             clip_groups=train and kind == "multibranch", **kw)


def _masked_out(b: GraphBatch) -> GraphBatch:
    """A copy of a host batch with every validity mask zeroed (and the
    segment plan's slots with them): shape-preserving remainder padding
    that contributes nothing."""
    masks = {}
    for name in ("node_mask", "edge_mask", "graph_mask", "seg_valid"):
        t = getattr(b, name)
        if t is not None:
            masks[name] = (torch.zeros_like(t) if isinstance(t, torch.Tensor)
                           else np.zeros_like(t))
    return dataclasses.replace(b, **masks)


class DPLoader:
    """This rank's slot of every dp step over a GraphLoader (the JAX
    package's ``DPLoader`` stacks all D slots): entry ``t * n + s`` of
    the base loader's epoch plan is slot ``s`` of step ``t``, where
    ``n`` is the node's slot count and ``s`` this rank's slot on it.
    Only this slot's entries are collated. The last short step is padded
    with masked copies of its own batches (``_masked_out``: slot ``n_real
    + i`` repeats batch ``i % n_real``). ``superstep_k > 1`` groups runs
    of K same-spec steps (``padschedule.dp_step_plan`` +
    ``superstep_groups``) into one ``MacroBatch`` of this slot's K
    batches. A fixed-order loader with ``cache_batches`` replays its
    first epoch's deliveries. ``skip_to(step)`` starts the next
    iteration at dp step ``step`` (the last short step counts as one),
    collating none of the consumed entries.

    ``loader`` may be a ``data/pipeline.ParallelPipelineLoader`` over the
    GraphLoader: its workers then collate this slot's entries
    (``iter_groups``) and deliver them in order, bit for bit the serial
    slot's batches."""

    def __init__(self, loader, mesh, superstep_k: int = 1):
        from hydragnn_tpu_torch.data.pipeline import ParallelPipelineLoader
        from hydragnn_tpu_torch.parallel.runtime import process_count, process_index

        self.loader = loader
        self._pipe = loader if isinstance(loader, ParallelPipelineLoader) else None
        self._base = loader.loader if self._pipe is not None else loader
        self.mesh = mesh
        self.superstep_k = max(1, int(superstep_k))
        p = process_count()
        if mesh.data % p:
            raise ValueError(f"data axis size {mesh.data} not divisible by {p} nodes")
        self.n = mesh.data // p
        self.slot = mesh.slot() - process_index() * self.n
        self._cache: Optional[list] = None
        self._skip_next = 0

    @staticmethod
    def required_hold(prefetch: int = 0) -> int:
        """The deliveries a ``ParallelPipelineLoader`` under this loader
        must keep a batch's recycled buffers for. The JAX package's
        ``DPLoader`` buffers the ``n`` slots (``K * n`` under supersteps)
        of a step before it stacks them; this one passes each delivery
        (a batch, or one ``MacroBatch`` holding all K) straight on, so
        what must be covered is the ``prefetch`` queue above it plus the
        batch in the loop's hands: a recycled delivery has then been
        copied to the card."""
        return max(2, int(prefetch) + 2)

    @property
    def dataset(self):
        return self._base.dataset

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)
        self._skip_next = 0

    def skip_to(self, step: int) -> None:
        """The next iteration drops the dp steps a cursor of ``step``
        covers (groups cut from the whole plan:
        ``data/loader.drop_consumed_groups``)."""
        self._skip_next = max(0, int(step))

    def _plan(self) -> list:
        return list(self._base.epoch_plan(self._base._epoch))

    def _groups(self, plan: list) -> List[int]:
        from hydragnn_tpu_torch.data.padschedule import dp_step_plan, superstep_groups

        steps, _ = dp_step_plan(plan, self.n)
        if self.superstep_k <= 1:
            return [1] * len(steps)
        return [len(g) for g in superstep_groups(steps, self.superstep_k)]

    def __len__(self) -> int:
        if not len(self._base):
            return 0
        plan = self._plan()
        return len(self._groups(plan)) + (1 if len(plan) % self.n else 0)

    def _collate(self, entries: list):
        batches = [self._base.collate_entry(*e) for e in entries]
        return MacroBatch(batches) if len(batches) > 1 else batches[0]

    def _deliveries(self, skip: int = 0):
        from hydragnn_tpu_torch.data.loader import drop_consumed_groups

        plan = self._plan()
        groups, t = [], 0
        for k in self._groups(plan):
            groups.append(list(range(t, t + k)))
            t += k
        tail = plan[t * self.n :]
        if tail:
            groups.append([t])
        entries, masked = [], []
        for steps in drop_consumed_groups(groups, skip):
            if steps[0] == t:  # the short last step
                mine = self.slot < len(tail)
                entries.append([tail[self.slot if mine else
                                     (self.slot - len(tail)) % len(tail)]])
                masked.append(not mine)
                continue
            entries.append([plan[s * self.n + self.slot] for s in steps])
            masked.append(False)
        items = (self._pipe.iter_groups(entries) if self._pipe is not None
                 else (self._collate(e) for e in entries))
        try:
            for item, m in zip(items, masked):
                yield _masked_out(item) if m else item
        finally:
            items.close()  # stops the pipeline's workers on an early exit

    def __iter__(self):
        for item in self._iter_items():
            telemetry.bump("dp_batches", len(item.batches) if isinstance(item, MacroBatch) else 1)
            yield item

    def _iter_items(self):
        from hydragnn_tpu_torch.data.loader import skip_delivered_items

        from hydragnn_tpu_torch.data.pipeline import owned_copy

        skip, self._skip_next = self._skip_next, 0
        pipe = self._pipe
        if self._cache is not None:
            yield from skip_delivered_items(self._cache, skip)
        else:
            cache = [] if self._base.cache_batches and not skip else None
            own = pipe is not None and pipe.recycle
            for item in self._deliveries(skip):
                if cache is not None:
                    cache.append(owned_copy(item) if own else item)
                yield item
            if cache is not None:
                self._cache = cache
        if pipe is not None:
            pipe.stats.epochs += 1
