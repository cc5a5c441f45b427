"""Segment reductions and receiver aggregation.

Counterpart of ``hydragnn_tpu/ops/segment.py``: ``segment_sum``,
``segment_mean``, ``segment_max``, ``segment_min``, ``segment_std``,
``segment_softmax``, ``degree``, the
``aggregate_receivers{,_product,_pipeline,_mean}`` family and PNA's
``segment_multi_aggregate``.

Dispatch. The JAX package chose between its Pallas kernel and XLA's
scatter with a crossover table of TPU measurements. The port reads no
such table: a batch that carries a block plan goes through K1
(``ops/edge_pipeline.edge_pipeline_planned``), which launches the Hopper
kernel on CUDA tensors and runs its plain version on CPU tensors. A
batch without a plan takes the plain scatter (``index_add_``), the
counterpart of the JAX package's XLA path; the serving engine always
attaches a plan.
"""

from __future__ import annotations

from typing import Optional

import torch

from hydragnn_tpu_torch.ops.edge_pipeline import (
    edge_pipeline_planned,
    segment_sum_planned,
    segment_sum_product_planned,
)


def _bcast(vec: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Reshape a [K] vector to broadcast against [K, ...] data."""
    return vec.reshape(vec.shape + (1,) * (data.dim() - vec.dim()))


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if mask is not None:
        data = torch.where(_bcast(mask, data), data, 0.0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def dense_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``segment_sum`` of [K, F] data as a one-hot matmul
    ``[num_segments, K] @ [K, F]``, for few segments (graph pooling). It
    uses no float atomics, so a CUDA run gives the same bits every time
    (the serving contract "served outputs equal a direct forward"
    depends on it), and no host sync, so the forward stays asynchronous
    and can be captured in a CUDA graph."""
    seg = torch.arange(num_segments, device=data.device, dtype=segment_ids.dtype)
    onehot = segment_ids[None, :] == seg[:, None]
    if mask is not None:
        onehot = onehot & mask[None, :]
    return (onehot.to(data.dtype) @ data.reshape(data.shape[0], -1)).reshape(
        (num_segments,) + tuple(data.shape[1:])
    )


def degree(
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    ones = torch.ones(segment_ids.shape[0], dtype=dtype, device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, 0.0)
    return ones.new_zeros(num_segments).index_add_(0, segment_ids, ones)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    dense: bool = False,
) -> torch.Tensor:
    """Masked mean per segment (empty segments give 0). ``dense`` sums
    with ``dense_segment_sum`` (no atomics, for few segments)."""
    reduce = dense_segment_sum if dense else segment_sum
    total = reduce(data, segment_ids, num_segments, mask)
    count = degree(segment_ids, num_segments, mask, dtype=data.dtype)
    count = torch.clamp(count, min=1)
    return total / _bcast(count, total)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    empty_value: float = 0.0,
) -> torch.Tensor:
    """Masked max per segment; empty segments give ``empty_value``."""
    neg = (
        torch.finfo(data.dtype).min
        if data.dtype.is_floating_point
        else torch.iinfo(data.dtype).min
    )
    if mask is not None:
        data = torch.where(_bcast(mask, data), data, neg)
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), neg,
        dtype=data.dtype, device=data.device,
    )
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
    return torch.where(out <= neg, float(empty_value), out)


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    empty_value: float = 0.0,
) -> torch.Tensor:
    """Masked min per segment: masked slots read ``finfo.max``, and a
    segment that nothing reaches (or only masked slots) gives
    ``empty_value``. Tied minima share the gradient equally, as JAX's
    ``segment_min`` does; the min is order-free, so CUDA runs agree."""
    pos = (
        torch.finfo(data.dtype).max
        if data.dtype.is_floating_point
        else torch.iinfo(data.dtype).max
    )
    if mask is not None:
        data = torch.where(_bcast(mask, data), data, pos)
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), pos,
        dtype=data.dtype, device=data.device,
    )
    idx = _bcast(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amin", include_self=False)
    return torch.where(out >= pos, float(empty_value), out)


def segment_std(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Per-segment standard deviation ``sqrt(max(E[x^2] - E[x]^2, 0) +
    eps)`` over the unmasked slots (an empty segment gives sqrt(eps)).
    The clamp is ``torch.maximum``, whose gradient splits a tie in half
    as JAX's ``maximum`` does."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    sq_mean = segment_mean(data * data, segment_ids, num_segments, mask)
    var = sq_mean - mean * mean
    var = torch.maximum(var, torch.zeros_like(var))
    return torch.sqrt(var + eps)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax of ``logits`` [K, ...] within segments: the masked segment
    max is subtracted, masked slots get zero weight, and the denominator
    is clamped at 1e-16 (a segment of masked slots only gives zeros)."""
    seg_max = segment_max(logits, segment_ids, num_segments, mask)
    ids = segment_ids.long()
    exp = torch.exp(logits - seg_max[ids])
    if mask is not None:
        exp = torch.where(_bcast(mask, exp), exp, 0.0)
    denom = exp.new_zeros((num_segments,) + tuple(exp.shape[1:])).index_add_(0, ids, exp)
    denom = torch.clamp(denom, min=1e-16)
    return exp / denom[ids]


def _plan(batch):
    """The batch's plan as K1's trailing arguments."""
    be, bn = batch.seg_tile
    return (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window,
            batch.num_nodes, bn, be)


def aggregate_receivers(msg: torch.Tensor, batch) -> torch.Tensor:
    """Receiver aggregation [E, F] -> [N, F]: K1 (reduce-only flavour)
    on a planned batch, the masked scatter otherwise. Padding edges are
    invalid plan slots, so no masked copy of ``msg`` is made."""
    if batch.seg_window is not None:
        return segment_sum_planned(msg, *_plan(batch))
    return segment_sum(
        msg, batch.receivers, batch.num_nodes, mask=batch.edge_mask
    )


def aggregate_receivers_product(
    a: torch.Tensor, b: torch.Tensor, batch
) -> torch.Tensor:
    """``segment_sum(a * b)`` at the receivers: K1 with the filter
    multiply inside on a planned batch, the masked scatter otherwise."""
    if batch.seg_window is not None:
        return segment_sum_product_planned(a, b, *_plan(batch))
    return segment_sum(
        a * b, batch.receivers, batch.num_nodes, mask=batch.edge_mask
    )


def aggregate_receivers_pipeline(
    a: torch.Tensor,
    b: Optional[torch.Tensor],
    batch,
    *,
    weight: Optional[torch.Tensor] = None,
    mean: bool = False,
) -> torch.Tensor:
    """The whole edge pipeline ``segment_sum((a * b) @ weight)``
    [N, F_out] (``b`` and ``weight`` optional; ``mean=True`` divides by
    the masked in-degree). A planned batch runs it as one K1 call, with
    the mean's degree scale applied after the sum (it commutes with the
    matmul). Without a plan it decomposes as the JAX fallback does:
    aggregate, divide, then the matmul."""
    count = None
    if mean:
        count = torch.clamp(
            degree(batch.receivers, batch.num_nodes, mask=batch.edge_mask,
                   dtype=a.dtype),
            min=1,
        )
    if batch.seg_window is not None:
        out = edge_pipeline_planned(a, b, weight, *_plan(batch))
        if count is not None:
            out = out / _bcast(count.to(out.dtype), out)
        return out
    if b is not None:
        out = aggregate_receivers_product(a, b, batch)
    else:
        out = aggregate_receivers(a, batch)
    if count is not None:
        out = out / _bcast(count.to(out.dtype), out)
    if weight is not None:
        out = out @ weight
    return out


def aggregate_receivers_mean(msg: torch.Tensor, batch) -> torch.Tensor:
    """Receiver mean aggregation [E, F] -> [N, F]: the dispatched sum,
    divided by the masked in-degree (clamped at 1)."""
    total = aggregate_receivers(msg, batch)
    count = degree(
        batch.receivers, batch.num_nodes, mask=batch.edge_mask,
        dtype=msg.dtype,
    )
    count = torch.clamp(count, min=1)
    return total / _bcast(count, total)


def segment_multi_aggregate(h: torch.Tensor, batch, *, eps: float = 1e-5):
    """PNA's (mean, min, max, std) aggregators in two passes over the
    edges. The moment pass sums ``concat([h, h * h])`` [E, 2F] through
    ``aggregate_receivers`` (K1, reduce-only, on a planned batch) for the
    mean and ``std = sqrt(max(E[h^2] - E[h]^2, 0) + eps)``; the extreme
    pass takes one ``segment_min`` of ``concat([h, -h])`` for min and
    max (an empty segment's max half reads -0.0, equal to 0). The clamp
    at zero is ``torch.maximum``, whose gradient splits a tie in half
    as JAX's ``maximum`` does (a receiver with one edge has var = 0)."""
    f = h.shape[-1]
    moments = aggregate_receivers(torch.cat([h, h * h], dim=-1), batch)
    count = torch.clamp(
        degree(batch.receivers, batch.num_nodes, mask=batch.edge_mask,
               dtype=h.dtype),
        min=1,
    )
    moments = moments / _bcast(count.to(moments.dtype), moments)
    mean, sq_mean = moments[:, :f], moments[:, f:]
    var = sq_mean - mean * mean
    var = torch.maximum(var, torch.zeros_like(var))
    std = torch.sqrt(var + eps)
    ext = segment_min(
        torch.cat([h, -h], dim=-1), batch.receivers, batch.num_nodes,
        mask=batch.edge_mask,
    )
    return mean, ext[:, :f], -ext[:, f:], std
