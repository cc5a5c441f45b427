"""Optimizer selection and the plateau scheduler.

Counterpart of ``hydragnn_tpu/train/optimizer.py``: ``select_optimizer``,
``get_learning_rate``/``set_learning_rate`` and ``ReduceLROnPlateau``.
The JAX package builds ``optax.inject_hyperparams(<optax optimizer>)``
with optax's defaults for SGD, Adam, AdamW, Adadelta, Adagrad, Adamax,
RMSprop and LAMB (FusedLAMB is ``optax.lamb`` too). The port writes each
update out in optax's order of operations, as plain tensor and
``torch._foreach_*`` code with optax's defaults set explicitly: torch's
own classes differ (AdamW decays the parameter before the step, Adagrad
adds eps outside the square root and starts from 0, RMSprop's decay is
0.99, and torch has no LAMB).

Every optimizer here can be captured in a CUDA graph (``train/capture.py``):
its state exists from construction, the step count and the learning rate
are device tensors (a 0-d tensor in each parameter group, as optax's
``inject_hyperparams`` holds the rate as an array), and a step makes no
host sync. ``set_learning_rate`` writes into that tensor in place, so a
graph captured before a ``ReduceLROnPlateau`` change replays with the new
rate; ``load_state_dict`` copies a checkpoint into the live tensors for
the same reason.

``Optimizer.clip_grad_norm`` > 0 scales the whole gradient by
``c / max(c, global_norm)`` before the update (optax's
``clip_by_global_norm``, computed on the device with no host sync);
absent or 0 leaves the update untouched.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

# optax's defaults, set explicitly (optax 0.2.6, optax/_src/alias.py).
_ADAM_BETAS = (0.9, 0.999)
_ADAM_EPS = 1e-8
_ADAMW_WEIGHT_DECAY = 1e-4
_LAMB_EPS = 1e-6
_ADADELTA = dict(rho=0.9, eps=1e-6)
_ADAGRAD = dict(initial_accumulator_value=0.1, eps=1e-7)
_RMSPROP = dict(decay=0.9, eps=1e-8)


def _moment_(m: List[torch.Tensor], g: List[torch.Tensor], decay: float) -> None:
    """optax's ``update_moment``: ``m = (1 - decay) * g + decay * m``,
    each product rounded before the add."""
    new = torch._foreach_mul(g, 1.0 - decay)
    torch._foreach_mul_(m, decay)
    torch._foreach_add_(m, new)


def copy_into(live: torch.Tensor, saved: torch.Tensor) -> None:
    """Copy a whole saved tensor into a live one in place; a live DTensor
    (an FSDP2 shard) takes its own shard of it."""
    if hasattr(live, "full_tensor"):
        from torch.distributed.tensor import distribute_tensor

        full = torch.as_tensor(saved).to(device=live.device, dtype=live.dtype)
        live.to_local().copy_(distribute_tensor(full, live.device_mesh,
                                                live.placements).to_local())
        return
    live.copy_(torch.as_tensor(saved))


class OptaxOptimizer:
    """One optax optimizer over a list of parameters.

    ``_scale(group, params, grads)`` returns optax's update direction
    ``u`` (before the learning rate) and advances the state; ``step``
    then applies ``p = p + (-lr) * u``, as optax's
    ``scale_by_learning_rate`` and ``apply_updates`` do. The group's
    ``lr`` and ``step`` (optax's ``count``) are 0-d tensors on the
    parameters' device in their dtype; per-parameter state tensors are
    made by ``_init_state`` at construction.

    The interface is the part of ``torch.optim.Optimizer`` the port uses
    (``param_groups``, ``state``, ``zero_grad``, ``step``, and
    ``state_dict``/``load_state_dict`` in torch's format), without its
    base class: that one imports ``torch._dynamo`` on first use, which
    took 9.4 s of the first ``run_training`` in a process on an NVIDIA
    H100 80GB HBM3 host."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, **hyper):
        params = list(params)
        like = params[0] if params else torch.zeros(())
        self.defaults = dict(lr=float(lr), **hyper)
        self.param_groups = [dict(
            hyper, params=params,
            lr=torch.tensor(float(lr), dtype=like.dtype, device=like.device),
            step=torch.zeros((), dtype=like.dtype, device=like.device),
        )]
        self.state = {p: self._init_state(p) for p in params}

    def _init_state(self, p: torch.Tensor) -> dict:
        return {}

    def _scale(self, group: dict, params, grads) -> List[torch.Tensor]:
        raise NotImplementedError

    def _bias_correction(self, group: dict, decay: float) -> torch.Tensor:
        """``1 - decay ** count`` (optax's ``bias_correction``)."""
        return 1.0 - torch.pow(decay, group["step"])

    def zero_grad(self, set_to_none: bool = True) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                if set_to_none:
                    p.grad = None
                elif p.grad is not None:
                    p.grad.detach_().zero_()

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            group["step"].add_(1.0)
            updates = self._scale(group, params, [p.grad for p in params])
            updates = torch._foreach_mul(updates, torch.neg(group["lr"]))
            torch._foreach_add_(params, updates)

    def state_dict(self) -> dict:
        """torch's layout: ``{"state": {index: {name: tensor}},
        "param_groups": [{..., "params": [index, ...]}]}``, the live
        tensors (``torch.save`` copies them)."""
        index = {}
        groups = []
        for group in self.param_groups:
            ids = [index.setdefault(id(p), len(index)) for p in group["params"]]
            groups.append(dict({k: v for k, v in group.items() if k != "params"}, params=ids))
        state = {index[id(p)]: dict(s) for p, s in self.state.items()}
        return {"state": state, "param_groups": groups}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Copy a ``state_dict`` into the live tensors (learning rates,
        step counts, per-parameter state), so graphs captured before the
        load read the loaded values. Raises when the layout differs."""
        groups = state_dict["param_groups"]
        if [len(g["params"]) for g in groups] != [len(g["params"]) for g in self.param_groups]:
            raise ValueError("optimizer state_dict has another parameter-group layout")
        params = [p for g in self.param_groups for p in g["params"]]
        for group, saved in zip(self.param_groups, groups):
            for k, v in saved.items():
                if k == "params":
                    continue
                if isinstance(group.get(k), torch.Tensor):
                    group[k].copy_(torch.as_tensor(v))
                else:
                    group[k] = v
        for i, saved in state_dict["state"].items():
            live = self.state[params[int(i)]]
            if set(saved) != set(live):
                raise ValueError(
                    f"optimizer state of parameter {i} holds {sorted(saved)}, "
                    f"this optimizer keeps {sorted(live)}"
                )
            for k, v in saved.items():
                copy_into(live[k], v)


class SGD(OptaxOptimizer):
    """``optax.sgd`` without momentum: ``u = g``."""

    def _scale(self, group, params, grads):
        return grads


class Adam(OptaxOptimizer):
    """``optax.adam`` / ``optax.adamw`` (``weight_decay`` > 0) /
    ``optax.lamb`` (``trust_ratio``): ``scale_by_adam``, then
    ``add_decayed_weights``, then LAMB's ``scale_by_trust_ratio``."""

    def __init__(self, params, lr, *, betas, eps, weight_decay=0.0, trust_ratio=False):
        super().__init__(params, lr, betas=tuple(betas), eps=float(eps),
                         weight_decay=float(weight_decay), trust_ratio=bool(trust_ratio))

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    def _scale(self, group, params, grads):
        b1, b2 = group["betas"]
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_avg_sq"] for p in params]
        _moment_(mu, grads, b1)
        _moment_(nu, torch._foreach_mul(grads, grads), b2)
        mu_hat = torch._foreach_div(mu, self._bias_correction(group, b1))
        den = torch._foreach_div(nu, self._bias_correction(group, b2))
        torch._foreach_sqrt_(den)  # eps_root is 0: sqrt(nu_hat + 0) is sqrt(nu_hat)
        torch._foreach_add_(den, group["eps"])
        u = torch._foreach_div(mu_hat, den)
        if group["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(params, group["weight_decay"]))
        if group["trust_ratio"]:
            # optax.scale_by_trust_ratio: |p| / |u| per parameter, 1 where
            # either norm is 0 (min_norm 0, trust coefficient 1, eps 0).
            pn = torch.stack(torch._foreach_norm(params))
            un = torch.stack(torch._foreach_norm(u))
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            torch._foreach_mul_(u, list(ratio.unbind()))
        return u


class Adamax(OptaxOptimizer):
    """``optax.adamax``: ``u = (mu / (1 - b1**t)) / nu`` with
    ``nu = max(|g| + eps, b2 * nu)``."""

    def __init__(self, params, lr, *, betas=_ADAM_BETAS, eps=_ADAM_EPS):
        super().__init__(params, lr, betas=tuple(betas), eps=float(eps))

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p), "exp_inf": torch.zeros_like(p)}

    def _scale(self, group, params, grads):
        b1, b2 = group["betas"]
        mu = [self.state[p]["exp_avg"] for p in params]
        nu = [self.state[p]["exp_inf"] for p in params]
        _moment_(mu, grads, b1)
        g_eps = torch._foreach_abs(grads)
        torch._foreach_add_(g_eps, group["eps"])
        torch._foreach_mul_(nu, b2)
        torch._foreach_maximum_(nu, g_eps)
        mu_hat = torch._foreach_div(mu, self._bias_correction(group, b1))
        return torch._foreach_div(mu_hat, nu)


class Adagrad(OptaxOptimizer):
    """``optax.adagrad`` (``scale_by_rss``): ``acc = g*g + acc`` from
    ``initial_accumulator_value``, ``u = rsqrt(acc + eps) * g`` where
    ``acc > 0``, else 0."""

    def __init__(self, params, lr, *, initial_accumulator_value, eps):
        super().__init__(params, lr, initial_accumulator_value=float(initial_accumulator_value),
                         eps=float(eps))

    def _init_state(self, p):
        return {"sum": torch.full_like(p, self.defaults["initial_accumulator_value"])}

    def _scale(self, group, params, grads):
        acc = [self.state[p]["sum"] for p in params]
        torch._foreach_add_(acc, torch._foreach_mul(grads, grads))
        inv = torch._foreach_add(acc, group["eps"])
        torch._foreach_rsqrt_(inv)
        inv = [torch.where(a > 0, s, torch.zeros_like(s)) for a, s in zip(acc, inv)]
        return torch._foreach_mul(inv, grads)


class RMSprop(OptaxOptimizer):
    """``optax.rmsprop`` (``scale_by_rms``, eps inside the square root,
    initial scale 0, not centered): ``nu = (1 - decay) g^2 + decay nu``,
    ``u = rsqrt(nu + eps) * g``."""

    def __init__(self, params, lr, *, decay, eps):
        super().__init__(params, lr, decay=float(decay), eps=float(eps))

    def _init_state(self, p):
        return {"square_avg": torch.zeros_like(p)}

    def _scale(self, group, params, grads):
        nu = [self.state[p]["square_avg"] for p in params]
        _moment_(nu, torch._foreach_mul(grads, grads), group["decay"])
        scaling = torch._foreach_add(nu, group["eps"])
        torch._foreach_rsqrt_(scaling)
        return torch._foreach_mul(scaling, grads)


class Adadelta(OptaxOptimizer):
    """``optax.adadelta`` (``scale_by_adadelta``; its weight decay is 0):
    ``e_g = (1 - rho) g^2 + rho e_g``, ``u = sqrt(e_x + eps) / sqrt(e_g +
    eps) * g``, ``e_x = (1 - rho) u^2 + rho e_x``."""

    def __init__(self, params, lr, *, rho, eps):
        super().__init__(params, lr, rho=float(rho), eps=float(eps))

    def _init_state(self, p):
        return {"square_avg": torch.zeros_like(p), "acc_delta": torch.zeros_like(p)}

    def _scale(self, group, params, grads):
        rho, eps = group["rho"], group["eps"]
        e_g = [self.state[p]["square_avg"] for p in params]
        e_x = [self.state[p]["acc_delta"] for p in params]
        _moment_(e_g, torch._foreach_mul(grads, grads), rho)
        num = torch._foreach_add(e_x, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(e_g, eps)
        torch._foreach_sqrt_(den)
        u = torch._foreach_div(num, den)
        torch._foreach_mul_(u, grads)
        _moment_(e_x, torch._foreach_mul(u, u), rho)
        return u


def select_optimizer(params: Iterable[torch.nn.Parameter], config: dict) -> OptaxOptimizer:
    """An optimizer over ``params`` from the ``Training.Optimizer``
    section (or a dict that is that section)."""
    opt_cfg = config.get("Optimizer", config)
    kind = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("learning_rate", 1e-3))
    params = list(params)
    if kind == "SGD":
        return SGD(params, lr)
    if kind in ("Adam", "AdamW"):
        wd = _ADAMW_WEIGHT_DECAY if kind == "AdamW" else 0.0
        return Adam(params, lr, betas=_ADAM_BETAS, eps=_ADAM_EPS, weight_decay=wd)
    if kind in ("LAMB", "FusedLAMB"):
        return Adam(params, lr, betas=_ADAM_BETAS, eps=_LAMB_EPS, trust_ratio=True)
    if kind == "Adamax":
        return Adamax(params, lr)
    if kind == "Adagrad":
        return Adagrad(params, lr, **_ADAGRAD)
    if kind == "RMSprop":
        return RMSprop(params, lr, **_RMSPROP)
    if kind == "Adadelta":
        return Adadelta(params, lr, **_ADADELTA)
    raise ValueError(f"Unknown optimizer type: {kind}")


def grad_clip_norm(config: dict) -> float:
    """``Optimizer.clip_grad_norm`` of the ``Training`` section (0 = off)."""
    return float(config.get("Optimizer", config).get("clip_grad_norm", 0) or 0)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> None:
    """Scale every gradient in place by ``max_norm / max(max_norm,
    global_norm)`` (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def get_learning_rate(optimizer: OptaxOptimizer) -> float:
    """The first group's learning rate (one device fetch)."""
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: OptaxOptimizer, lr: float) -> None:
    """Write ``lr`` into every parameter group's learning-rate tensor in
    place (never rebinding it), so captured steps replay with it."""
    for group in optimizer.param_groups:
        group["lr"].fill_(float(lr))


class ReduceLROnPlateau:
    """Host-side plateau scheduler with torch's semantics (relative
    threshold, patience counted in epochs)."""

    def __init__(
        self,
        factor: float = 0.5,
        patience: int = 5,
        min_lr: float = 1e-8,
        threshold: float = 1e-4,
    ):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float, current_lr: float) -> float:
        """Returns the (possibly reduced) learning rate."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
            return current_lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr
