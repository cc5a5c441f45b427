"""GPS hybrid layer: local message passing plus dense global attention.

Counterpart of ``hydragnn_tpu/models/gps.py``: ``GPSInputEmbed`` (node
features and Laplacian PE, and the relative PE of the edges, lifted to
the hidden width before the conv stack), ``_masked_softmax_attention``
(the ``multihead`` engine), ``_linear_attention`` (the ``performer``
engine: elu + 1 features), ``GlobalAttention`` and ``GPSLayer``.
Attention runs over the masked dense per-graph layout of
``ops/dense.py``, written out in ``einsum``/``softmax``: a padding
graph's fully masked rows get uniform weights, as in the reference, and
are dropped on the way back (``scaled_dot_product_attention`` with a
boolean mask would return NaN there). As in the reference, training is
deterministic (the reference configs' attention dropout is 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.models.layers import MLP, Dense, MaskedBatchNorm
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.dense import from_dense_batch, to_dense_batch


class GPSInputEmbed(nn.Module):
    """Lift node features + Laplacian PE (and the relative PE, with the
    edge features when ``edge_dim`` is set) to ``hidden_dim``. The port
    builds the relative-PE lift whenever GPS is on, as the data path
    attaches ``rel_pe`` with ``pe`` (``data/raw.py``)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_dim
        if not cfg.pe_dim:
            raise ValueError(
                "GPS global attention requires Laplacian PE; set pe_dim>0 so "
                "the data pipeline attaches batch.pe"
            )
        self.pos_emb = Dense(cfg.pe_dim, h, bias=False)
        if cfg.input_dim:
            self.node_emb = Dense(cfg.input_dim, h)
            self.node_lin = Dense(2 * h, h, bias=False)
        self.rel_pos_emb = Dense(cfg.pe_dim, h, bias=False)
        if cfg.edge_dim:
            self.edge_emb = Dense(cfg.edge_dim, h, bias=False)
            self.edge_lin = Dense(2 * h, h, bias=False)

    def forward(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if batch.pe is None:
            raise ValueError(
                "GPS global attention requires Laplacian PE; set pe_dim>0 so "
                "the data pipeline attaches batch.pe"
            )
        x = self.pos_emb(batch.pe)
        if hasattr(self, "node_emb"):
            xn = self.node_emb(batch.x)
            x = self.node_lin(torch.cat([xn, x], dim=-1))
        e = None
        if batch.rel_pe is not None:
            e = self.rel_pos_emb(batch.rel_pe)
            if batch.edge_attr is not None:
                ee = self.edge_emb(batch.edge_attr)
                e = self.edge_lin(torch.cat([ee, e], dim=-1))
        return x, e


def _masked_softmax_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Exact attention over [G, H, S, Dh] with key padding mask [G, S]."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("ghqd,ghkd->ghqk", q * scale, k)
    neg = torch.finfo(logits.dtype).min
    logits = torch.where(mask[:, None, None, :], logits, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("ghqk,ghkd->ghqd", w, v)


def _linear_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Performer-style linear attention with phi(x) = elu(x) + 1."""
    qf = F.elu(q) + 1.0
    kf = (F.elu(k) + 1.0) * mask[:, None, :, None]
    kv = torch.einsum("ghkd,ghke->ghde", kf, v)
    z = torch.einsum("ghqd,ghd->ghq", qf, kf.sum(dim=2))
    out = torch.einsum("ghqd,ghde->ghqe", qf, kv)
    return out / torch.clamp(z[..., None], min=1e-6)


class GlobalAttention(nn.Module):
    """Multi-head attention over the dense per-graph layout [G, S, C]."""

    def __init__(self, channels: int, heads: int, attn_type: Optional[str] = "multihead"):
        super().__init__()
        self.channels = channels
        self.heads = max(heads, 1)
        if (channels // self.heads) * self.heads != channels:
            raise ValueError(
                f"hidden_dim {channels} not divisible by global_attn_heads {self.heads}"
            )
        if attn_type not in (None, "multihead", "performer"):
            raise ValueError(f"Unsupported attn_type {attn_type!r}")
        self.attn_type = attn_type
        for name in ("q", "k", "v", "out"):
            self.add_module(name, Dense(channels, channels))

    def forward(self, dense: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        g, s, _ = dense.shape
        heads = self.heads

        def proj(name):
            y = getattr(self, name)(dense)
            return y.reshape(g, s, heads, -1).transpose(1, 2)

        q, k, v = proj("q"), proj("k"), proj("v")
        if self.attn_type == "performer":
            o = _linear_attention(q, k, v, mask)
        else:
            o = _masked_softmax_attention(q, k, v, mask)
        return self.out(o.transpose(1, 2).reshape(g, s, self.channels))


class GPSLayer(nn.Module):
    """One GPS block: the local conv output plus the layer input, normed;
    global attention over the layer input plus it, normed; their sum
    through an MLP residual and a last norm."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.num_nodes is None:
            raise ValueError(
                "GPS requires cfg.num_nodes (a static per-graph node bound, "
                "derived by update_config from the data)"
            )
        ch = cfg.hidden_dim
        self.max_nodes = int(cfg.num_nodes)
        self.norm1 = MaskedBatchNorm(ch)
        self.attn = GlobalAttention(
            ch, cfg.global_attn_heads or 1, cfg.global_attn_type or "multihead"
        )
        self.norm2 = MaskedBatchNorm(ch)
        self.mlp = MLP(ch, (2 * ch, ch), act=cfg.activation)
        self.norm3 = MaskedBatchNorm(ch)

    def forward(self, inv_in: torch.Tensor, h_local: torch.Tensor, batch) -> torch.Tensor:
        h1 = self.norm1(h_local + inv_in, batch.node_mask)
        dense, mask = to_dense_batch(inv_in, batch, self.max_nodes)
        attn = self.attn(dense, mask)
        h2 = from_dense_batch(attn, batch, self.max_nodes) + inv_in
        h2 = self.norm2(h2, batch.node_mask)
        out = h1 + h2
        out = out + self.mlp(out)
        return self.norm3(out, batch.node_mask)
