"""Multibranch task-parallel training (the GFM workload).

Counterpart of ``hydragnn_tpu/parallel/multibranch.py``: every rank (the
JAX package's device slot) is assigned a branch, its batches hold only
that branch's samples (``MultiBranchLoader``), and all branch decoders
live in every rank's model. The step takes the *unweighted* mean of the
ranks' losses (each rank's loss times 1/D before its backward, the
gradients summed: ``parallel/dp.Reduction`` with ``kind
"multibranch"``), then scales each branch's decoder gradients by D / D_b
(``decoder_grad_scales``), which turns the mean over all D ranks into
the mean over the branch's D_b ranks, since the other ranks' samples
never reach that branch's heads: the reference's two process-group
reduction. The rescale is only right under the equal mean, so dp's graph
weighting is not shared here. ``dual_optimizer`` steps the encoder and
decoder parameter groups as two optimizers (optax's
``multi_transform``: each group its own step count and clip), and
``accumulate`` is ``optax.MultiSteps``.

Decoder parameters are found by name as in the JAX package: a path with
a component starting ``decoder`` (the port's ``decoder``/``decoder_<i>``
modules), and within it a module ``graph_shared_<branch>`` or
``head<i>_<branch>``, longest branch name first.

The divergence guard (``Training.Guard``) contains a bad step per
branch: the guarded step's predicate is a vector over
``branch_guard_labels`` (each branch decoder, then the encoder), read off
each slot's gradients after the all-reduce and before the D / D_b
rescale, and the commit selects each slot's tensors on its own
(``train/guard.BranchSlots``), so one branch's poison never holds back
another branch's update. The steps run eagerly over gloo
(``parallel/dp.capturable``), so the guard lives in the eager step.
``MultiBranchLoader.skip_to`` fast-forwards every slot's plan to a
mid-epoch cursor, which the resume manifest records per branch
(``branch_steps``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hydragnn_tpu_torch.data.graph import GraphSample, PadSpec, optional_field_widths
from hydragnn_tpu_torch.data.loader import GraphLoader
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.train.optimizer import OptaxOptimizer, select_optimizer
from hydragnn_tpu_torch.utils import telemetry


def proportional_branch_split(dataset_sizes: Sequence[int], n_devices: int) -> List[int]:
    """Devices per branch, proportional to dataset sizes, >= 1 each."""
    k = len(dataset_sizes)
    if n_devices < k:
        raise ValueError(f"{n_devices} devices < {k} branches")
    total = float(sum(dataset_sizes))
    raw = [max(1, int(n_devices * s / total)) for s in dataset_sizes]
    while sum(raw) > n_devices:
        raw[int(np.argmax(raw))] -= 1
    while sum(raw) < n_devices:
        raw[int(np.argmin(raw))] += 1
    if min(raw) < 1:
        raise ValueError(f"branch with zero devices: {raw}")
    return raw


def branch_of_device(devices_per_branch: Sequence[int]) -> np.ndarray:
    """``[D]`` branch of each slot (branch-major order)."""
    return np.repeat(np.arange(len(devices_per_branch)), devices_per_branch).astype(np.int32)


def _branch_name_index(cfg: ModelConfig) -> Dict[str, int]:
    names: Dict[str, int] = {}
    for lst in (cfg.graph_branches, cfg.node_branches):
        for bi, b in enumerate(lst):
            names.setdefault(b.name, bi)
    return names


def decoder_branch_of_name(name: str, cfg: ModelConfig) -> Optional[int]:
    """The branch of a decoder parameter from its dotted name, None for
    an encoder parameter."""
    keys = name.split(".")
    if not any(k.startswith("decoder") for k in keys):
        return None
    index = _branch_name_index(cfg)
    by_len = sorted(index, key=len, reverse=True)
    for k in keys:
        for b in by_len:
            if k.endswith(f"_{b}"):
                return index[b]
    return None


def branch_guard_labels(n_branches: int) -> List[str]:
    """The multibranch guard's slot labels, in its predicate's order: one
    per branch decoder, then the shared encoder."""
    return [f"branch-{i}" for i in range(n_branches)] + ["encoder"]


def guard_slots(model: torch.nn.Module, cfg: ModelConfig, n_branches: int):
    """The guard's ``BranchSlots`` for ``model``: each branch decoder
    parameter in its branch's slot, by the name rule of
    ``decoder_grad_scales``."""
    from hydragnn_tpu_torch.train.guard import BranchSlots

    of = {}
    for name, p in model.named_parameters():
        bi = decoder_branch_of_name(name, cfg)
        if bi is not None:
            of[p] = bi
    return BranchSlots(labels=tuple(branch_guard_labels(n_branches)), of=of)


def decoder_grad_scales(model: torch.nn.Module, cfg: ModelConfig, n_devices: int,
                        devices_per_branch: Sequence[int]) -> Dict[torch.nn.Parameter, float]:
    """``{parameter: D / D_b}`` for every branch decoder parameter
    (``rescale_decoder_grads``'s factors)."""
    out = {}
    for name, p in model.named_parameters():
        bi = decoder_branch_of_name(name, cfg)
        if bi is not None:
            out[p] = n_devices / devices_per_branch[bi]
    return out


def rescale_decoder_grads(grads: Dict[str, torch.Tensor], cfg: ModelConfig, n_devices: int,
                          devices_per_branch: Sequence[int]) -> Dict[str, torch.Tensor]:
    """``{name: gradient}`` with each branch decoder's gradient scaled by
    D / D_b (the others unchanged)."""
    out = {}
    for name, g in grads.items():
        bi = decoder_branch_of_name(name, cfg)
        out[name] = g if bi is None else g * (n_devices / devices_per_branch[bi])
    return out


def make_multibranch_train_step(model, optimizer, cfg: ModelConfig, plan,
                                devices_per_branch: Sequence[int],
                                compute_dtype=torch.float32, clip_norm: float = 0.0,
                                compute_grad_energy: bool = False, guard: bool = False):
    """``step(state, batch) -> (state, loss, per_task)``: one eager
    multibranch step on this rank's slot (module docstring). ``guard``
    returns ``(state, loss, per_task, n_graphs, ok, gnorm)`` with ``ok``
    and ``gnorm`` over ``branch_guard_labels``."""
    from hydragnn_tpu_torch.parallel.dp import Reduction
    from hydragnn_tpu_torch.train.loop import make_train_step

    scales = decoder_grad_scales(model, cfg, plan.data_parallel_size, devices_per_branch)
    slots = guard_slots(model, cfg, len(devices_per_branch)) if guard else None
    return make_train_step(model, optimizer, cfg, compute_dtype, clip_norm, compute_grad_energy,
                           red=Reduction(model, plan, kind="multibranch", decoder_scales=scales),
                           clip_groups=True, guard=guard, slots=slots)


class MultiBranchLoader:
    """This rank's slot of every multibranch step: a loader per slot over
    its branch's samples (``dataset_id`` set to the branch; a branch's
    samples dealt round-robin over its slots; seeds ``seed + 1000 * b +
    i``), built on every rank so that the epoch length (the least over
    all slots) and the shared shapes agree with no collective. Every
    slot's t-th batch pads to one spec: the step's ``slot_spec_schedule``
    entry (``variable_pad``; ``"auto"`` when its ladder stays within the
    bucket limit), else the worst case over all slots. ``skip_to``
    starts the next iteration at a mid-epoch step."""

    def __init__(self, branch_datasets: Sequence[Sequence[GraphSample]],
                 devices_per_branch: Sequence[int], batch_size: int, slot: int, *,
                 shuffle: bool = True, seed: int = 0, with_triplets: bool = False,
                 variable_pad: "bool | str" = False, with_segment_plan: bool = True):
        from hydragnn_tpu_torch.data.padschedule import slot_spec_schedule

        self.slot = int(slot)
        self._skip_next = 0
        # one optional-field map over every branch: each step's slots
        # must collate to one structure
        shared_fields = optional_field_widths([s for b in branch_datasets for s in b])
        self.loaders: List[GraphLoader] = []
        for bi, n_dev in enumerate(devices_per_branch):
            samples = [dataclasses.replace(s, dataset_id=bi) for s in branch_datasets[bi]]
            for di in range(n_dev):
                shard = samples[di::n_dev]
                if not shard:
                    raise ValueError(
                        f"Branch {bi}: device shard {di}/{n_dev} is empty ({len(samples)} "
                        f"samples over {n_dev} devices); reduce devices_per_branch or add data"
                    )
                self.loaders.append(GraphLoader(
                    shard, batch_size, shuffle=shuffle, seed=seed + 1000 * bi + di,
                    with_triplets=with_triplets, with_segment_plan=with_segment_plan,
                    ensure_fields=shared_fields))
        if variable_pad and not with_triplets:
            sched = slot_spec_schedule(self.loaders)
            if variable_pad != "auto" or sched.ladder_is_small():
                for ld in self.loaders:
                    ld.spec_schedule = sched
                    ld.pad_spec = None
                    ld.fixed_pad = False
                return
        specs = [ld.pad_spec for ld in self.loaders if ld.pad_spec]
        if specs:
            trips = [s.num_triplets for s in specs if s.num_triplets]
            shared = PadSpec(num_nodes=max(s.num_nodes for s in specs),
                             num_edges=max(s.num_edges for s in specs),
                             num_graphs=max(s.num_graphs for s in specs),
                             num_triplets=max(trips) if trips else None)
            for ld in self.loaders:
                ld.pad_spec = shared

    @property
    def dataset(self):
        return self.loaders[self.slot].dataset

    def set_epoch(self, epoch: int) -> None:
        for ld in self.loaders:
            ld.set_epoch(epoch)
        self._skip_next = 0  # a cursor never outlives its epoch

    def skip_to(self, step) -> None:
        """The next iteration starts at step ``step`` of the epoch: every
        slot's loader skips the plan entries the cursor covers (plan
        arithmetic only; ``GraphLoader.skip_to``), so the deliveries are
        the uninterrupted run's suffix. ``step`` may be the manifest's
        per-branch cursors (``branch_steps``), which must agree: the
        branches run in lockstep."""
        if isinstance(step, (list, tuple)):
            vals = {int(s) for s in step}
            if len(vals) > 1:
                raise ValueError(
                    f"multibranch per-branch cursors disagree ({list(step)}): the feed "
                    "consumes branches in lockstep and cannot fast-forward them unequally")
            step = vals.pop() if vals else 0
        step = max(0, int(step))
        for ld in self.loaders:
            ld.skip_to(step)
        self._skip_next = step

    def __len__(self) -> int:
        return min(len(ld) for ld in self.loaders)

    def __iter__(self):
        skip, self._skip_next = self._skip_next, 0
        it = iter(self.loaders[self.slot])
        for _ in range(len(self) - min(skip, len(self))):
            telemetry.bump("mb_batches")
            yield next(it)


def _is_decoder(name: str) -> bool:
    return any(k.startswith("decoder") for k in name.split("."))


def dual_optimizer(model: torch.nn.Module, training_cfg: dict,
                   decoder_lr: Optional[float] = None) -> OptaxOptimizer:
    """The DualOptimizer (optax ``multi_transform`` of the JAX package):
    the ``Training`` optimizer over the encoder's parameters and another
    over the decoders' (``decoder_lr`` defaults to the shared rate), as
    one optimizer with two parameter groups, encoder first, each with
    its own step count and learning-rate tensors (so both capture and
    ``set_learning_rate`` reach both)."""
    named = list(model.named_parameters())
    enc = [p for n, p in named if not _is_decoder(n)]
    dec = [p for n, p in named if _is_decoder(n)]
    dec_cfg = dict(training_cfg)
    if decoder_lr is not None:
        opt = dict(dec_cfg.get("Optimizer", {}))
        opt["learning_rate"] = decoder_lr
        dec_cfg["Optimizer"] = opt
    tx = select_optimizer(enc, training_cfg)
    other = select_optimizer(dec, dec_cfg)
    if not enc:
        return other
    if dec:
        tx.param_groups += other.param_groups
        tx.state.update(other.state)
    return tx


class MultiSteps:
    """``optax.MultiSteps``: gradients averaged over ``every`` calls
    (``acc + (g - acc) / (n + 1)``) and the wrapped optimizer stepped on
    the average at every ``every``-th call; between them parameters and
    the wrapped state stay as they were. Eager (a host counter)."""

    def __init__(self, optimizer: OptaxOptimizer, every: int):
        self.inner = optimizer
        self.every = max(1, int(every))
        self.param_groups = optimizer.param_groups
        self.state = optimizer.state
        self.mini_step = 0
        self._acc = {p: torch.zeros_like(p) for g in self.param_groups for p in g["params"]}

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in self._acc.items():
            if p.grad is not None:
                acc.add_((p.grad - acc) / (n + 1))
        if n == self.every - 1:
            for p, acc in self._acc.items():
                p.grad = acc.clone()
                acc.zero_()
            self.inner.step()
        self.mini_step = (n + 1) % self.every

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": [a for a in self._acc.values()]}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        self.inner.load_state_dict(state_dict["inner"])
        self.mini_step = int(state_dict["mini_step"])
        for a, v in zip(self._acc.values(), state_dict["acc"]):
            a.copy_(v)


def accumulate(optimizer: OptaxOptimizer, every: int) -> MultiSteps:
    """no_sync gradient accumulation (the reference's ``--nosync``):
    a sync and an update every ``every`` steps."""
    return MultiSteps(optimizer, every)
