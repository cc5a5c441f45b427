"""Masked dense per-graph layouts for GPS global attention.

Counterpart of ``hydragnn_tpu/ops/dense.py``: ``to_dense_batch`` scatters
the flat node array into ``[G, S, F]`` by the collated ``node_slot``,
and ``from_dense_batch`` gathers it back. Nodes whose slot is at or past
``max_nodes`` (S) are dropped, as the reference's ``mode="drop"`` does:
they are written to one spare row past the ``G * S`` slots, which is cut
off, so no index leaves the tensor (on CUDA an out-of-range index is a
device-side assert) and none lands on a real slot. Neither function
syncs with the host, so the forward stays capturable.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hydragnn_tpu_torch.ops.segment import _bcast


def to_dense_batch(
    x: torch.Tensor, batch, max_nodes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat [N, F] -> dense [G, S, F] plus its validity mask [G, S];
    padding nodes write zeros, slots past a graph's size stay zero."""
    g = batch.num_graphs
    slot = batch.node_slot.long()
    flat = torch.where(
        slot < max_nodes, batch.node_graph_idx.long() * max_nodes + slot, g * max_nodes
    )
    contrib = torch.where(_bcast(batch.node_mask, x), x, 0)
    dense = x.new_zeros((g * max_nodes + 1,) + tuple(x.shape[1:]))
    dense = dense.index_put((flat,), contrib)
    mask = torch.zeros(g * max_nodes + 1, dtype=torch.bool, device=x.device)
    mask = mask.index_put((flat,), batch.node_mask)
    return (
        dense[:-1].reshape((g, max_nodes) + tuple(x.shape[1:])),
        mask[:-1].reshape(g, max_nodes),
    )


def from_dense_batch(dense: torch.Tensor, batch, max_nodes: int) -> torch.Tensor:
    """Dense [G, S, F] -> flat [N, F]; padding nodes and nodes past the
    bound read zero, matching ``to_dense_batch``."""
    slot = batch.node_slot.long()
    flat = dense[batch.node_graph_idx.long(), torch.clamp(slot, max=max_nodes - 1)]
    valid = batch.node_mask & (slot < max_nodes)
    return torch.where(_bcast(valid, flat), flat, 0)
