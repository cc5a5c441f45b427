"""Invariant (batch-normed) stacks: GIN, SAGE, MFC, CGCNN and GAT.

Counterpart of ``hydragnn_tpu/models/invariant.py``: ``_InvariantStack``
(a stack whose convs read only the node features and the batch, with
``norm_kind = "batch"`` so the multihead core puts a ``MaskedBatchNorm``
after every conv layer), ``GINConv``, ``SAGEConv``, ``MFConv``,
``CGConv``, ``GATv2Conv`` and their stacks. PNA and PNAPlus
(``models/pna.py``) build on the same scaffolding. Every conv gathers,
computes per edge and sums at the receivers with the masked scatter
(``segment_sum``/``segment_mean``, ``index_add_``), as the JAX stacks
sum with XLA's scatter: none of them runs the fused edge pipeline.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.models.layers import Dense
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.segment import (
    degree,
    segment_mean,
    segment_softmax,
    segment_sum,
)


class _InvariantStack(nn.Module):
    """Convs ``conv_{i}`` called as ``conv(inv, batch)``; positions pass
    through unchanged."""

    norm_kind = "batch"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def conv_in_dim(self, i: int) -> int:
        """Layer ``i``'s input width: the GPS embedding's hidden width, or
        the node features' at layer 0 without GPS."""
        cfg = self.cfg
        return cfg.hidden_dim if i > 0 or cfg.use_global_attn else cfg.input_dim

    def conv_out_dim(self, i: int) -> int:
        """Layer ``i``'s output width (the width its feature norm takes)."""
        return self.cfg.hidden_dim

    def embed(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        return batch.x, batch.pos, {}

    def conv(self, i, inv, equiv, batch, extras):
        return getattr(self, f"conv_{i}")(inv, batch), equiv


def _gather_sum(x: torch.Tensor, batch) -> torch.Tensor:
    """``segment_sum(x[senders])`` at the receivers over valid edges."""
    return segment_sum(x[batch.senders.long()], batch.receivers, batch.num_nodes,
                       mask=batch.edge_mask)


class GINConv(nn.Module):
    """``mlp((1 + eps) x + sum of neighbours)``, a two-layer ReLU MLP
    (``mlp0``, ``mlp1``) and a scalar ``eps`` initialized to 100."""

    eps_init = 100.0

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(self.eps_init))
        self.mlp0 = Dense(in_dim, out_dim)
        self.mlp1 = Dense(out_dim, out_dim)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        # flax promotes: the f32 eps lifts a bf16 x to f32, as Dense does
        dt = torch.promote_types(x.dtype, self.eps.dtype)
        h = (1.0 + self.eps.to(dt)) * x.to(dt) + _gather_sum(x, batch)
        return self.mlp1(F.relu(self.mlp0(h)))


class SAGEConv(nn.Module):
    """GraphSAGE: ``lin_neigh(mean of neighbours) + lin_root(x)``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin_neigh = Dense(in_dim, out_dim)
        self.lin_root = Dense(in_dim, out_dim)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        neigh = segment_mean(x[batch.senders.long()], batch.receivers, batch.num_nodes,
                             mask=batch.edge_mask)
        return self.lin_neigh(neigh) + self.lin_root(x)


class MFConv(nn.Module):
    """Molecular-fingerprint conv with per-degree weights: ``x @
    w_root[d] + agg @ w_neigh[d] + bias[d]`` for a node of in-degree
    ``d`` (clipped at ``max_degree``). The JAX stack gathers a ``[N, in,
    out]`` weight per node; a torch gather over a handful of distinct
    degrees has a serialized backward, so this computes every degree's
    product at once (``[N, max_degree + 1, out]``) and selects each
    node's with ``gather``, and the bias with a one-hot matmul. The
    selected entries are the same sums."""

    def __init__(self, in_dim: int, out_dim: int, max_degree: int):
        super().__init__()
        self.max_degree = int(max_degree)
        self.w_root = nn.Parameter(torch.empty(self.max_degree + 1, in_dim, out_dim))
        self.w_neigh = nn.Parameter(torch.empty(self.max_degree + 1, in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(self.max_degree + 1, out_dim))

    def _per_degree(self, x: torch.Tensor, w: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
        d1, f_in, f_out = w.shape
        dt = torch.promote_types(x.dtype, w.dtype)
        all_deg = x.to(dt) @ w.to(dt).permute(1, 0, 2).reshape(f_in, d1 * f_out)
        return all_deg.reshape(-1, d1, f_out).gather(1, sel).squeeze(1)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        agg = _gather_sum(x, batch)
        deg = degree(batch.receivers, batch.num_nodes, mask=batch.edge_mask)
        deg = torch.clamp(deg.to(torch.int64), 0, self.max_degree)
        f_out = self.bias.shape[1]
        sel = deg[:, None, None].expand(-1, 1, f_out)
        # no F.one_hot: on CUDA it checks the range with a host sync
        onehot = deg[:, None] == torch.arange(self.max_degree + 1, device=deg.device)
        onehot = onehot.to(self.bias.dtype)
        return (self._per_degree(x, self.w_root, sel)
                + self._per_degree(agg, self.w_neigh, sel) + onehot @ self.bias)


class CGConv(nn.Module):
    """Crystal-graph conv, channels kept: ``x + sum over edges of
    sigmoid(lin_f(z)) * softplus(lin_s(z))``, ``z = [x_rcv, x_snd
    (, edge_attr)]``."""

    def __init__(self, channels: int, edge_dim: Optional[int] = None,
                 edge_in: Optional[int] = None):
        super().__init__()
        self.edge_dim = edge_dim
        z_dim = 2 * channels + (edge_in if edge_dim else 0)
        self.lin_f = Dense(z_dim, channels)
        self.lin_s = Dense(z_dim, channels)

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        z = [x[batch.receivers.long()], x[batch.senders.long()]]
        if self.edge_dim and batch.edge_attr is not None:
            z.append(batch.edge_attr)
        z = torch.cat(z, dim=-1)
        msg = torch.sigmoid(self.lin_f(z)) * F.softplus(self.lin_s(z))
        return x + segment_sum(msg, batch.receivers, batch.num_nodes, mask=batch.edge_mask)


class GATv2Conv(nn.Module):
    """GATv2 attention with ``heads`` heads of width ``out_dim``: logits
    ``att . leaky_relu(lin_l(x)_snd + lin_r(x)_rcv (+ lin_edge(e)))``, a
    softmax over each receiver's edges, the weighted sum of ``lin_l(x)_snd``;
    heads concatenated (``concat``) or averaged."""

    def __init__(self, in_dim: int, out_dim: int, heads: int, negative_slope: float,
                 concat: bool, edge_dim: Optional[int] = None,
                 edge_in: Optional[int] = None):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.negative_slope = negative_slope
        self.concat = concat
        self.edge_dim = edge_dim
        self.lin_l = Dense(in_dim, heads * out_dim)
        self.lin_r = Dense(in_dim, heads * out_dim)
        if edge_dim:
            self.lin_edge = Dense(edge_in, heads * out_dim)
        self.att = nn.Parameter(torch.empty(heads, out_dim))

    def forward(self, x: torch.Tensor, batch) -> torch.Tensor:
        h, d = self.heads, self.out_dim
        snd, rcv = batch.senders.long(), batch.receivers.long()
        x_src = self.lin_l(x).reshape(-1, h, d)
        x_dst = self.lin_r(x).reshape(-1, h, d)
        e = x_src[snd] + x_dst[rcv]
        if self.edge_dim and batch.edge_attr is not None:
            e = e + self.lin_edge(batch.edge_attr).reshape(-1, h, d)
        e = F.leaky_relu(e, self.negative_slope)
        dt = torch.promote_types(e.dtype, self.att.dtype)
        logits = torch.einsum("ehd,hd->eh", e.to(dt), self.att.to(dt))
        alpha = segment_softmax(logits, batch.receivers, batch.num_nodes, mask=batch.edge_mask)
        out = segment_sum(x_src[snd] * alpha[..., None], batch.receivers, batch.num_nodes,
                          mask=batch.edge_mask)
        return out.reshape(-1, h * d) if self.concat else out.mean(dim=1)


class GINStack(_InvariantStack):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        for i in range(cfg.num_conv_layers):
            self.add_module(f"conv_{i}", GINConv(self.conv_in_dim(i), cfg.hidden_dim))


class SAGEStack(_InvariantStack):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        for i in range(cfg.num_conv_layers):
            self.add_module(f"conv_{i}", SAGEConv(self.conv_in_dim(i), cfg.hidden_dim))


class MFCStack(_InvariantStack):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        if cfg.max_neighbours is None:
            raise ValueError("MFC requires max_neighbours")
        for i in range(cfg.num_conv_layers):
            self.add_module(
                f"conv_{i}", MFConv(self.conv_in_dim(i), cfg.hidden_dim, cfg.max_neighbours)
            )


def _edge_in(cfg: ModelConfig) -> Optional[int]:
    """The width of ``batch.edge_attr``: the GPS embedding replaces it
    with its hidden-wide lift."""
    return cfg.hidden_dim if cfg.use_global_attn else cfg.edge_dim


class CGCNNStack(_InvariantStack):
    """CGConv keeps its channels (``update_config`` sets hidden_dim =
    input_dim without GPS), so every layer is as wide as its input."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        for i in range(cfg.num_conv_layers):
            self.add_module(
                f"conv_{i}", CGConv(self.conv_in_dim(i), cfg.edge_dim, _edge_in(cfg))
            )

    def conv_out_dim(self, i: int) -> int:
        return self.conv_in_dim(i)


class GATStack(_InvariantStack):
    """GATv2 with 6 heads and negative slope 0.05; every layer but the
    last concatenates its heads, so it is ``6 x hidden_dim`` wide."""

    heads = 6
    negative_slope = 0.05

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        for i in range(cfg.num_conv_layers):
            self.add_module(
                f"conv_{i}",
                GATv2Conv(self.conv_in_dim(i), cfg.hidden_dim, self.heads,
                          self.negative_slope, concat=not self._last(i),
                          edge_dim=cfg.edge_dim, edge_in=_edge_in(cfg)),
            )

    def _last(self, i: int) -> bool:
        return i == self.cfg.num_conv_layers - 1

    def conv_in_dim(self, i: int) -> int:
        if i > 0:
            return self.conv_out_dim(i - 1)
        return super().conv_in_dim(i)

    def conv_out_dim(self, i: int) -> int:
        return self.cfg.hidden_dim * (1 if self._last(i) else self.heads)
