"""The divergence guard: a non-finite train step contained on the device,
and the host's skip -> rollback -> halt ladder.

Counterpart of ``hydragnn_tpu/train/guard.py``:

- ``guarded_commit`` is the step's predicate and containment:
  ``ok = isfinite(loss) & isfinite(global gradient norm)``, the norm
  taken from the gradients before ``clip_grad_norm`` scales them (as
  optax's chain hands ``guarded_commit`` raw gradients). The JAX step
  selects between two immutable trees; the port's optimizers and batch
  norms update their tensors in place, so a guarded step first copies
  every tensor the step writes (parameters, running statistics, the
  optimizer's moments, step counts and learning rates: ``StateShadow``)
  into buffers made once, and after the update writes back
  ``torch.where(ok, new, saved)`` into each. A select passes the taken
  side through exactly, so a healthy guarded run equals the unguarded
  run bit for bit, and a bad step leaves the state as it was. The loss,
  the per-task terms and the graph weight are zeroed on a bad step, so
  the epoch's sums equal those of a run that never saw the batch. The
  train state's device step counter advances on every step, skipped or
  not, so an armed ``nan`` rule fires once.
- ``poison_scalar``/``poison_grads``/``poison_batch`` are the drills'
  ``nan:<site>@<step>`` injections (``utils/faults.py``), read once when
  a step is built and compared against the device step counter, so they
  land inside a captured graph as they do in an eager step. They select
  NaN, never add it.
- ``GuardMonitor`` holds each dispatch's predicate and norm as device
  tensors and fetches them in one copy at the end of the epoch (or every
  ``check_interval_steps``), then escalates by ``Guard.policy``:
  ``skip`` reports, ``rollback`` raises ``GuardRollback`` once more than
  ``max_bad_steps`` fall within ``window_steps`` (the loop restores the
  last good checkpoint, backs the learning rate off and skips past the
  bad steps), ``halt`` (or a spent ``max_rollbacks``) raises
  ``GuardHalt`` with a report. Each epoch (and each escalation) emits a
  ``health`` row onto the run's telemetry stream.

Under dp the predicate reads the loss and gradients after the
all-reduce, so every rank decides alike with no collective added (under
ZeRO the norm of the sharded gradients is one all-reduce).

Under the multibranch scheme (``parallel/multibranch.py``) the predicate
is a vector over ``BranchSlots``: one slot per branch decoder, then the
encoder (``branch_guard_labels``' order). Each tensor of the shadow
belongs to one slot: a branch decoder's parameters and their optimizer
state to that branch's, everything else (encoder parameters, floating
buffers, every group's step count and learning rate) to the encoder's.
Slot ``b`` commits iff the norm of its gradients (after the all-reduce,
before the D / D_b rescale) is finite, the encoder slot iff the mean
loss and its norm are, so one branch's poison never holds back another
branch's update; a clip group spanning several slots joins their
predicates, since its scale carries a non-finite gradient to all of
them. The loss terms are zeroed when any slot fails, and the monitor
keeps a bad-step window per slot (``window_bad_by_branch``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.utils import faults
from hydragnn_tpu_torch.utils.print_utils import print_distributed

_POLICIES = ("skip", "rollback", "halt")


@dataclass(frozen=True)
class GuardSettings:
    """The resolved ``Training.Guard`` block (``Guard: true`` is
    ``{"enabled": true}``: the skip policy, checked at epoch end)."""

    enabled: bool = False
    policy: str = "skip"
    max_bad_steps: int = 3
    window_steps: int = 100
    check_interval_steps: int = 0
    lr_backoff: float = 0.5
    max_rollbacks: int = 2


def guard_settings(training: dict) -> GuardSettings:
    """``Training.Guard`` resolved as the JAX package resolves it (its
    unknown keys are refused by ``config.update_config``)."""
    raw = training.get("Guard") or {}
    if isinstance(raw, bool):
        raw = {"enabled": raw}
    elif not isinstance(raw, dict):
        raise ValueError(
            "Training.Guard must be a bool or an object "
            '{"enabled", "policy", "max_bad_steps", "window_steps", '
            '"check_interval_steps", "lr_backoff", "max_rollbacks"}'
        )
    policy = str(raw.get("policy", "skip"))
    if policy not in _POLICIES:
        raise ValueError(f"Training.Guard.policy {policy!r} not in {_POLICIES}")
    backoff = float(raw.get("lr_backoff", 0.5))
    if not 0.0 < backoff <= 1.0:
        raise ValueError(f"Training.Guard.lr_backoff must be in (0, 1], got {backoff}")
    return GuardSettings(
        enabled=bool(raw.get("enabled", False)),
        policy=policy,
        max_bad_steps=max(0, int(raw.get("max_bad_steps", 3))),
        window_steps=max(1, int(raw.get("window_steps", 100))),
        check_interval_steps=max(0, int(raw.get("check_interval_steps", 0))),
        lr_backoff=backoff,
        max_rollbacks=max(0, int(raw.get("max_rollbacks", 2))),
    )


class GuardRollback(Exception):
    """The window holds too many bad steps under the ``rollback``
    policy; ``bad_steps`` are this epoch's, the loop's cursor domain."""

    def __init__(self, bad_steps: List[int], message: str):
        super().__init__(message)
        self.bad_steps = list(bad_steps)


class GuardHalt(RuntimeError):
    """Training cannot safely continue; the message is the report."""


# ---------------------------------------------------------------- injection


def nan_injections() -> Dict[str, List[int]]:
    """The armed ``nan`` rules, read when a step is built."""
    return faults.nan_rules()


def _trigger(steps: Sequence[int], counter: torch.Tensor) -> torch.Tensor:
    hit = counter == int(steps[0])
    for s in steps[1:]:
        hit = hit | (counter == int(s))
    return hit


def poison_scalar(rules: dict, site: str, counter, x: torch.Tensor) -> torch.Tensor:
    """``x`` with NaN selected in at the armed steps (``x`` itself when
    no rule names ``site``)."""
    steps = rules.get(site) if rules else None
    if not steps:
        return x
    return torch.where(_trigger(steps, counter), torch.full_like(x, float("nan")), x)


def poison_grads(rules: dict, counter, params: Sequence[torch.Tensor]) -> None:
    """Every floating gradient of ``params`` replaced by NaN at the armed
    ``grad`` steps."""
    steps = rules.get("grad") if rules else None
    if not steps:
        return
    hit = _trigger(steps, counter)
    for p in params:
        if p.grad is not None and p.grad.is_floating_point():
            p.grad = torch.where(hit, torch.full_like(p.grad, float("nan")), p.grad)


def poison_batch(rules: dict, counter, batch):
    """The batch with its node features NaN at the armed ``batch``
    steps (loss and gradients both go non-finite)."""
    steps = rules.get("batch") if rules else None
    if not steps:
        return batch
    x = torch.where(_trigger(steps, counter), torch.full_like(batch.x, float("nan")), batch.x)
    return dataclasses.replace(batch, x=x)


def rules_key(rules: dict) -> tuple:
    """The armed rules as a hashable part of a step's graph-cache key:
    an armed and an unarmed build never share a graph."""
    return tuple(sorted((site, tuple(steps)) for site, steps in (rules or {}).items()))


# ---------------------------------------------------------------- containment


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP2), else the tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


@dataclass(frozen=True)
class BranchSlots:
    """The multibranch guard's slots (module docstring): ``labels`` in
    ``branch_guard_labels`` order, ``of`` each branch decoder
    parameter's slot (a parameter absent from it is the encoder's, the
    last slot)."""

    labels: Tuple[str, ...]
    of: Dict[torch.Tensor, int]

    @property
    def encoder(self) -> int:
        return len(self.labels) - 1

    def slot(self, p) -> int:
        return self.of.get(p, self.encoder)


class StateShadow:
    """A flat buffer per dtype holding, for the length of one step, every
    tensor the step writes: the model's parameters and floating buffers
    (running statistics), and the optimizer's per-parameter state and its
    groups' 0-d step counts and learning rates. Made once when a step is
    built, so a captured step copies into the same addresses on every
    replay; saving is one ``cat`` per dtype, selecting one ``cat``, one
    ``where`` and one multi-tensor copy, whatever the tensor count. With
    ``slots`` each buffer holds its tensors slot by slot, and a select
    over a per-slot predicate adds one ``repeat_interleave`` that spreads
    it over the elements."""

    def __init__(self, model: torch.nn.Module, optimizer, slots: Optional[BranchSlots] = None):
        enc = 0 if slots is None else slots.encoder
        slot = (lambda p: enc) if slots is None else slots.slot
        live = [(p.detach(), slot(p)) for p in model.parameters()]
        live += [(b, enc) for b in model.buffers() if b.is_floating_point()]
        for group in optimizer.param_groups:
            live += [(v, enc) for v in group.values() if isinstance(v, torch.Tensor)]
        for p, st in optimizer.state.items():
            live += [(v, slot(p)) for v in st.values() if isinstance(v, torch.Tensor)]
        by_kind: dict = {}
        for t, s in live:
            t = _local(t)
            by_kind.setdefault((t.dtype, t.device), []).append((s, t))
        self.groups = []
        for (dt, dev), members in by_kind.items():
            counts = None
            if slots is not None:
                members.sort(key=lambda m: m[0])  # stable: slot by slot
                per = [0] * len(slots.labels)
                for s, t in members:
                    per[s] += t.numel()
                counts = torch.tensor(per, dtype=torch.int64, device=dev)
            ts = [t for _, t in members]
            self.groups.append((ts, torch.empty(sum(t.numel() for t in ts), dtype=dt,
                                                device=dev), counts))

    @staticmethod
    def _flat(ts, out=None):
        return torch.cat([t.reshape(-1) for t in ts], out=out)

    def save(self) -> None:
        with torch.no_grad():
            for ts, saved, _ in self.groups:
                self._flat(ts, out=saved)

    def select(self, ok: torch.Tensor) -> None:
        """Keep each tensor's new value where ``ok`` (a scalar, or a
        vector over the slots), else its saved one."""
        with torch.no_grad():
            for ts, saved, counts in self.groups:
                new = self._flat(ts)
                if counts is not None:
                    ok_t = torch.repeat_interleave(ok, counts, output_size=saved.numel())
                else:
                    ok_t = ok
                torch.where(ok_t, new, saved, out=new)
                views, at = [], 0
                for t in ts:
                    views.append(new[at:at + t.numel()].view(t.shape))
                    at += t.numel()
                torch._foreach_copy_(ts, views)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the 2-norm over every gradient (f32),
    whole over the ranks for ZeRO's sharded gradients."""
    grads = list(grads)
    if not grads:
        return torch.zeros(())
    if any(hasattr(g, "full_tensor") for g in grads):
        norms = []
        for g in grads:
            n = torch.linalg.vector_norm(g.float())
            full = getattr(n, "full_tensor", None)
            norms.append(full() if callable(full) else n)
    else:
        norms = torch._foreach_norm([g.float() if g.dtype != torch.float32 else g
                                     for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def slot_norms(grads: Sequence[torch.Tensor], slot_of: Sequence[int],
               n_slots: int) -> torch.Tensor:
    """``[n_slots]``: ``global_norm`` of each slot's gradients (0 for a
    slot without any); ``slot_of[i]`` is ``grads[i]``'s slot."""
    by_slot: List[list] = [[] for _ in range(n_slots)]
    for g, s in zip(grads, slot_of):
        by_slot[s].append(g)
    dev = grads[0].device if grads else None
    return torch.stack([global_norm(gs) if gs else torch.zeros((), device=dev)
                        for gs in by_slot])


def guarded_commit(shadow: StateShadow, tot, tasks, n_graphs, gnorm,
                   joined: Sequence[torch.Tensor] = ()):
    """The predicate and the containment after the update (module
    docstring): returns ``(tot, tasks, n_graphs)`` zeroed on a bad step,
    the predicate ``ok`` and ``gnorm``. A ``[n_slots]`` ``gnorm`` (the
    multibranch guard's ``slot_norms``) gives a ``[n_slots]`` ``ok``, the
    encoder's (last) slot also reading the loss; ``joined`` holds, as
    index tensors, the slot sets that one clip group spans, each
    committing only whole."""
    if gnorm.dim() == 0:
        ok = torch.isfinite(tot) & torch.isfinite(gnorm)
        shadow.select(ok)
        every = ok
    else:
        ok = torch.isfinite(gnorm)
        ok[-1] = ok[-1] & torch.isfinite(tot)
        for members in joined:
            ok[members] = ok[members].all()
        shadow.select(ok)
        every = ok.all()
    zero = torch.zeros((), dtype=tot.dtype, device=tot.device)
    return (torch.where(every, tot, zero), torch.where(every, tasks, torch.zeros_like(tasks)),
            torch.where(every, n_graphs, torch.zeros_like(n_graphs)), ok, gnorm)


# ---------------------------------------------------------------- the ladder


class GuardMonitor:
    """Drives the policy ladder from the per-step predicates the guarded
    steps return (module docstring). ``observe`` runs after every
    dispatch and only appends, unless the sampled cadence is due;
    ``epoch_end`` fetches the epoch's predicates in one copy and
    escalates. Bad steps are windowed in run-global step numbers.

    ``branches`` (the multibranch guard's slot labels) makes the window
    per slot: the steps' predicates are ``[n_slots]`` vectors, each bad
    step keeps its bad slots, escalation counts the worst single slot
    (one branch's bad steps never add to another's), the warning names
    the slots, and the ``health`` row gains ``window_bad_by_branch``."""

    def __init__(self, settings: GuardSettings, verbosity: int = 0,
                 branches: Optional[Sequence[str]] = None):
        self.settings = settings
        self.verbosity = verbosity
        self.branches = list(branches) if branches else None
        self.epoch = 0
        self.skipped_total = 0
        self.rollbacks = 0
        # (global step, epoch, epoch step, bad slots) of the window's bad steps
        self.bad_steps_recent: List[tuple] = []
        self.bad_steps_all: List[tuple] = []  # (epoch, epoch step)
        self._last_gstep = 0
        self._epoch_base = 0
        self._epoch_max_step = 0
        self.epoch_bad: List[int] = []
        self._gn_min = float("inf")
        self._gn_max = 0.0
        self._gn_sum = 0.0
        self._gn_count = 0
        self._pending: List[tuple] = []  # (first_step, k, ok_ref, gnorm_ref)
        self._since_check = 0

    def note_epoch(self, epoch: int) -> None:
        self._epoch_base += self._epoch_max_step
        self._epoch_max_step = 0
        self.epoch = int(epoch)
        self.epoch_bad = []
        self._gn_min, self._gn_max = float("inf"), 0.0
        self._gn_sum, self._gn_count = 0.0, 0
        self._pending = []
        self._since_check = 0

    def observe(self, *, step: int, k: int, ok_ref, gnorm_ref) -> None:
        """One dispatch: ``step`` is this epoch's step count after it,
        ``k`` the steps it covered, the refs its ``[k]`` (or scalar;
        ``[k, n_slots]`` with ``branches``) predicate and norm, held
        unfetched."""
        self._pending.append((int(step) - int(k), int(k), ok_ref, gnorm_ref))
        if self.settings.check_interval_steps > 0:
            self._since_check += int(k)
            if self._since_check >= self.settings.check_interval_steps:
                self._since_check = 0
                self.check()

    def epoch_end(self) -> None:
        """Resolve the epoch's pending predicates, escalate, and emit the
        epoch's ``health`` row (also when escalating)."""
        try:
            self.check()
        finally:
            self._emit_health("epoch")

    def _fetch(self, pending) -> List[tuple]:
        """Each dispatch's ``([k, n_slots] oks, [k, n_slots] norms)``
        (one slot for a scalar predicate), in one copy."""
        parts = []
        for _, k, ok, gn in pending:
            parts.append(torch.as_tensor(ok).reshape(-1).to(torch.float64))
            parts.append(torch.as_tensor(gn).reshape(-1).to(torch.float64))
        # graftlint: disable-next-line=host-sync -- the guard's designed resolution point: epoch-end (after the loop's own metrics fetch) or the opt-in Guard.check_interval_steps sampled cadence, never per dispatch
        flat = torch.cat([p.to(parts[0].device) for p in parts]).cpu().numpy()
        out, at = [], 0
        for i, (_, k, _, _) in enumerate(pending):
            n = parts[2 * i].numel()
            out.append(((flat[at:at + n] != 0).reshape(k, -1),
                        flat[at + n:at + 2 * n].reshape(k, -1)))
            at += 2 * n
        return out

    def check(self) -> None:
        """Fetch the pending predicates (one copy) and run the ladder;
        raises ``GuardRollback``/``GuardHalt`` by policy."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        new_bad: List[tuple] = []  # (epoch step, bad slots)
        for (first_step, k, _, _), (oks, gns) in zip(pending, self._fetch(pending)):
            # the slots partition the gradients: their root-sum-square is
            # the step's whole norm, which the statistics keep
            gns = np.sqrt((gns ** 2).sum(axis=1)) if gns.shape[1] > 1 else gns.reshape(-1)
            finite = gns[np.isfinite(gns)]
            if finite.size:
                self._gn_min = min(self._gn_min, float(finite.min()))
                self._gn_max = max(self._gn_max, float(finite.max()))
                self._gn_sum += float(finite.sum())
                self._gn_count += int(finite.size)
            new_bad += [(first_step + j, tuple(int(s) for s in np.flatnonzero(~oks[j])))
                        for j in range(k) if not oks[j].all()]
            self._epoch_max_step = max(self._epoch_max_step, first_step + k)
            self._last_gstep = max(self._last_gstep, self._epoch_base + first_step + k)
        if not new_bad:
            return
        self.skipped_total += len(new_bad)
        self.epoch_bad.extend(b for b, _ in new_bad)
        self.bad_steps_recent.extend((self._epoch_base + b, self.epoch, b, slots)
                                     for b, slots in new_bad)
        self.bad_steps_all.extend((self.epoch, b) for b, _ in new_bad)
        where = ""
        if self.branches:
            names = sorted({self._label(s) for _, slots in new_bad for s in slots})
            where = f" [slots: {', '.join(names)}]"
        self._warn(
            f"non-finite step(s) SKIPPED on-device at optimizer step(s) "
            f"{[b for b, _ in new_bad]} (epoch {self.epoch}){where} — loss/grad-norm "
            "predicate failed; the affected params/optimizer state untouched"
        )
        self._escalate()

    def _label(self, slot: int) -> str:
        return self.branches[slot] if slot < len(self.branches) else f"slot{slot}"

    def _window_bad(self) -> int:
        """The window's bad steps, or under ``branches`` the worst single
        slot's."""
        if self.branches is None:
            return len(self.bad_steps_recent)
        per: Dict[int, int] = {}
        for *_, slots in self.bad_steps_recent:
            for s in slots:
                per[s] = per.get(s, 0) + 1
        return max(per.values(), default=0)

    def _escalate(self) -> None:
        s = self.settings
        lo = self._last_gstep - s.window_steps
        self.bad_steps_recent = [b for b in self.bad_steps_recent if b[0] > lo]
        window_bad = self._window_bad()
        if s.policy == "skip" or window_bad <= s.max_bad_steps:
            return
        if s.policy == "halt" or self.rollbacks >= s.max_rollbacks:
            self._emit_health("halt")
            raise GuardHalt(self.report(window_bad))
        self._emit_health("rollback")
        raise GuardRollback(
            [es for _, ep, es, _ in self.bad_steps_recent if ep == self.epoch],
            f"{window_bad} bad step(s) within the last {s.window_steps} steps "
            f"(> max_bad_steps={s.max_bad_steps}) — rolling back to the last-known-good "
            "checkpoint",
        )

    def note_rollback(self, cursor_step: int, new_lr: float) -> None:
        """After the loop restored a checkpoint: count the rollback and
        clear the window."""
        self.rollbacks += 1
        self.bad_steps_recent = []
        self._pending = []
        self._since_check = 0
        self._warn(
            f"ROLLBACK #{self.rollbacks}: restored last-known-good cursor step "
            f"{cursor_step} of epoch {self.epoch}, lr backed off to {new_lr:.3e}"
        )

    def report(self, window_bad: Optional[int] = None) -> str:
        """The halt report."""
        recent = [f"e{ep}:s{es}" for ep, es in self.bad_steps_all[-16:]]
        n = window_bad if window_bad is not None else len(self.bad_steps_recent)
        return (
            "training HALTED by the divergence guard: "
            f"{self.skipped_total} non-finite step(s) total ({n} in the last "
            f"{self.settings.window_steps}-step window, threshold "
            f"{self.settings.max_bad_steps}), {self.rollbacks}/{self.settings.max_rollbacks} "
            f"rollback(s) spent; recent bad optimizer steps {recent} (epoch {self.epoch}); "
            f"injected fault plan: {faults.plan_spec()!r}. The last-known-good checkpoint "
            "is the newest artifact under logs/<run>/ (the writer's validate-finite gate "
            "never published a non-finite state). Likely causes: corrupted/outlier input "
            "data around those steps, an LR too hot for this precision, or bf16 "
            "activation overflow — lower Training.Optimizer.learning_rate or set "
            "Training.Optimizer.clip_grad_norm, then `continue` from the checkpoint."
        )

    def gnorm_stats(self) -> Optional[dict]:
        if not self._gn_count:
            return None
        return {"gnorm_min": self._gn_min, "gnorm_max": self._gn_max,
                "gnorm_mean": self._gn_sum / self._gn_count, "gnorm_steps": self._gn_count}

    def _emit_health(self, action: str) -> None:
        """One ``health`` row onto the run's telemetry stream (a no-op
        with the stream off), as docs/OBSERVABILITY.md gives it; under
        ``branches`` with the window's bad steps per slot label
        (``window_bad_by_branch``)."""
        from hydragnn_tpu_torch.utils import telemetry

        if not telemetry.active():
            return
        row = {
            "t": "health",
            "action": action,
            "epoch": self.epoch,
            "bad_steps": self.epoch_bad[-64:],
            "bad_count": len(self.epoch_bad),
            "window_bad": len(self.bad_steps_recent),
            "skipped_total": self.skipped_total,
            "rollbacks": self.rollbacks,
            "policy": self.settings.policy,
        }
        if self.branches:
            counts: Dict[str, int] = {}
            for *_, slots in self.bad_steps_recent:
                for s in slots:
                    counts[self._label(s)] = counts.get(self._label(s), 0) + 1
            row["window_bad_by_branch"] = counts
        gn = self.gnorm_stats()
        if gn:
            row.update(gn)
        spec = faults.plan_spec()
        if spec:
            row["fault_plan"] = spec
        telemetry.emit(row)

    def _warn(self, msg: str) -> None:
        print_distributed(self.verbosity, 0, f"[guard] {msg}")
