"""Optimizer selection and the plateau scheduler.

Counterpart of ``hydragnn_tpu/train/optimizer.py``: ``select_optimizer``,
``get_learning_rate``/``set_learning_rate`` and ``ReduceLROnPlateau``.
The JAX package builds optax transforms with optax's defaults; the port
builds ``torch.optim`` optimizers with those defaults set explicitly,
because torch's differ (AdamW's weight decay is 1e-4 in optax, 1e-2 in
torch). The other optax optimizers (Adadelta, Adagrad, Adamax, RMSprop,
LAMB) raise until they are ported (ROADMAP Queue 1 item 6).

``Optimizer.clip_grad_norm`` > 0 scales the whole gradient by
``c / max(c, global_norm)`` before the update (optax's
``clip_by_global_norm``, computed on the device with no host sync);
absent or 0 leaves the update untouched.
"""

from __future__ import annotations

from typing import Iterable

import torch

# optax's defaults (optax.adamw / adam / sgd), set explicitly.
_ADAM_BETAS = (0.9, 0.999)
_ADAM_EPS = 1e-8
_ADAMW_WEIGHT_DECAY = 1e-4


def select_optimizer(params: Iterable[torch.nn.Parameter], config: dict) -> torch.optim.Optimizer:
    """An optimizer over ``params`` from the ``Training.Optimizer``
    section (or a dict that is that section)."""
    opt_cfg = config.get("Optimizer", config)
    kind = opt_cfg.get("type", "AdamW")
    lr = float(opt_cfg.get("learning_rate", 1e-3))
    params = list(params)
    if kind == "AdamW":
        opt: torch.optim.Optimizer = torch.optim.AdamW(
            params, lr=lr, betas=_ADAM_BETAS, eps=_ADAM_EPS,
            weight_decay=_ADAMW_WEIGHT_DECAY,
        )
    elif kind == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=_ADAM_BETAS, eps=_ADAM_EPS)
    elif kind == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.0)
    elif kind in ("Adadelta", "Adagrad", "Adamax", "RMSprop", "LAMB", "FusedLAMB"):
        raise NotImplementedError(
            f"optimizer {kind} is not ported yet (its optax defaults differ "
            "from torch's): ROADMAP Queue 1 item 6"
        )
    else:
        raise ValueError(f"Unknown optimizer type: {kind}")
    return opt


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


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every parameter group's learning rate."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


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
