"""Loss functions and the multihead task-weighted loss.

Counterpart of ``hydragnn_tpu/train/losses.py``: ``masked_mean`` (with
its denominator ``max(sum(mask) * size(err) / size(mask), 1)``),
``elementwise_loss`` (mse / mae / smooth_l1), ``head_loss`` (plus rmse
and GaussianNLLLoss) and ``multihead_loss``: per-task losses over the
real (masked) graphs or nodes, weighted by the |w|-normalized task
weights.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from hydragnn_tpu_torch.models.spec import ModelConfig


def masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(err.dtype)
    if err.dim() > 1:
        m = m.reshape(m.shape + (1,) * (err.dim() - 1))
    denom = torch.clamp(m.sum() * (err.numel() / mask.numel()), min=1.0)
    return (err * m).sum() / denom


def elementwise_loss(kind: str, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if kind == "mse":
        return (pred - target) ** 2
    if kind == "mae":
        return torch.abs(pred - target)
    if kind == "smooth_l1":
        d = torch.abs(pred - target)
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    raise ValueError(f"Unknown loss function: {kind}")


def head_loss(
    kind: str,
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    var: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if kind == "rmse":
        return torch.sqrt(masked_mean(elementwise_loss("mse", pred, target), mask))
    if kind == "GaussianNLLLoss":
        v = torch.clamp(var, min=1e-6)
        return masked_mean(0.5 * (torch.log(v) + (pred - target) ** 2 / v), mask)
    return masked_mean(elementwise_loss(kind, pred, target), mask)


def multihead_loss(
    outputs: List[torch.Tensor], batch, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(task-weighted total, per-task losses [num_heads]). ``outputs[h]``
    is ``[K, dim * (1 + var_output)]``; targets are the static column
    ranges of ``batch.y_graph`` / ``batch.y_node``."""
    tot = None
    tasks = []
    for hi, (level, start, end) in enumerate(cfg.head_offsets()):
        head = cfg.heads[hi]
        out = outputs[hi]
        pred = out[:, : head.dim]
        var = out[:, head.dim :] ** 2 if cfg.var_output else None
        if level == "graph":
            target, mask = batch.y_graph[:, start:end], batch.graph_mask
        else:
            target, mask = batch.y_node[:, start:end], batch.node_mask
        task = head_loss(cfg.loss_function_type, pred, target, mask, var)
        tasks.append(task)
        term = cfg.task_weights[hi] * task
        tot = term if tot is None else tot + term
    return tot, torch.stack(tasks)
