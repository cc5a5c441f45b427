"""PNA and PNAPlus stacks: Principal Neighborhood Aggregation.

Counterpart of ``hydragnn_tpu/models/pna.py``: ``_deg_stats``,
``pna_scaled_aggregate``, ``PNAConv``, ``PNAStack`` and ``PNAPlusStack``
(PNAConv with a Bessel radial basis of the edge length under DimeNet's
envelope, embedded into the message input and multiplied into the
message). The four aggregators (mean, min, max, std) run as two passes
(``ops/segment.segment_multi_aggregate``): the moment pass is one
reduce-only K1 launch of width 2F on a planned batch, whose backward is
one K2 launch. The degree statistics are host-side scalars from the
config's ``pna_deg`` histogram.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hydragnn_tpu_torch.models.invariant import _InvariantStack
from hydragnn_tpu_torch.models.layers import Dense
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.rbf import edge_vectors_and_lengths, envelope
from hydragnn_tpu_torch.ops.segment import degree, segment_multi_aggregate


def _deg_stats(pna_deg: Tuple[int, ...]) -> Tuple[float, float]:
    """(avg_deg_lin, avg_deg_log) of the degree histogram (PyG's
    DegreeScalerAggregation)."""
    hist = np.asarray(pna_deg, dtype=np.float64)
    ds = np.arange(hist.shape[0])
    total = max(hist.sum(), 1.0)
    avg_lin = float((hist * ds).sum() / total)
    avg_log = float((hist * np.log(ds + 1)).sum() / total)
    return max(avg_lin, 1e-6), max(avg_log, 1e-6)


def pna_scaled_aggregate(
    h: torch.Tensor,
    batch,
    avg_deg_lin: float,
    avg_deg_log: float,
    *,
    inverse_linear: bool = False,
) -> torch.Tensor:
    """[mean, min, max, std] times the degree scalers identity,
    amplification, attenuation and linear (and inverse linear when
    asked): [N, 16F] (20F). Degrees are clamped at 1, as PyG does."""
    mean, mn, mx, std = segment_multi_aggregate(h, batch)
    aggs = torch.cat([mean, mn, mx, std], dim=-1)
    d = torch.clamp(
        degree(batch.receivers, batch.num_nodes, mask=batch.edge_mask), min=1.0
    )
    log_d = torch.log(d + 1.0)
    amp = (log_d / avg_deg_log)[:, None]
    att = (avg_deg_log / log_d)[:, None]
    lin = (d / avg_deg_lin)[:, None]
    parts = [aggs, aggs * amp, aggs * att, aggs * lin]
    if inverse_linear:
        parts.append(aggs * (avg_deg_lin / d)[:, None])
    return torch.cat(parts, dim=-1)


class PNAConv(torch.nn.Module):
    """Multi-aggregator conv with degree scalers (towers 1, one pre and
    one post layer). ``num_radial`` set gives the PNAPlus flavour;
    ``edge_in`` is the width of ``batch.edge_attr`` when ``edge_dim`` is
    set."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        avg_deg_lin: float,
        avg_deg_log: float,
        edge_dim: Optional[int] = None,
        num_radial: Optional[int] = None,
        edge_in: Optional[int] = None,
    ):
        super().__init__()
        self.avg_deg_lin = avg_deg_lin
        self.avg_deg_log = avg_deg_log
        self.edge_dim = edge_dim
        self.num_radial = num_radial
        f = in_dim
        n_parts = 2
        if num_radial is not None:
            self.rbf_emb = Dense(num_radial, f)
            if edge_dim:
                self.edge_encoder = Dense(edge_in + f, f)
            n_parts += 1
        elif edge_dim:
            self.edge_encoder = Dense(edge_in, f)
            n_parts += 1
        self.pre_nn = Dense(n_parts * f, f)
        if num_radial is not None:
            self.rbf_lin = Dense(num_radial, f, bias=False)
        self.post_nn = Dense(f + 16 * f, out_dim)
        self.lin = Dense(out_dim, out_dim)

    def forward(
        self, x: torch.Tensor, batch, rbf: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        snd, rcv = batch.senders.long(), batch.receivers.long()
        has_edges = self.edge_dim and batch.edge_attr is not None
        parts = [x[rcv], x[snd]]
        if self.num_radial is not None:
            rbf_feat = F.relu(self.rbf_emb(rbf))
            if has_edges:
                parts.append(self.edge_encoder(torch.cat([batch.edge_attr, rbf_feat], -1)))
            else:
                parts.append(rbf_feat)
        elif has_edges:
            parts.append(self.edge_encoder(batch.edge_attr))
        h = self.pre_nn(torch.cat(parts, dim=-1))
        if self.num_radial is not None:
            h = h * self.rbf_lin(rbf)
        scaled = pna_scaled_aggregate(h, batch, self.avg_deg_lin, self.avg_deg_log)
        out = self.post_nn(torch.cat([x, scaled], dim=-1))
        return self.lin(out)


class PNAStack(_InvariantStack):
    """PNA over plain edges."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self._check()
        avg_lin, avg_log = _deg_stats(cfg.pna_deg)
        # The GPS embedding replaces edge_attr with its hidden-wide lift.
        edge_in = cfg.hidden_dim if cfg.use_global_attn else cfg.edge_dim
        for i in range(cfg.num_conv_layers):
            self.add_module(
                f"conv_{i}",
                PNAConv(
                    self.conv_in_dim(i), cfg.hidden_dim, avg_lin, avg_log,
                    edge_dim=cfg.edge_dim, num_radial=self._num_radial(),
                    edge_in=edge_in,
                ),
            )

    def _check(self) -> None:
        if self.cfg.pna_deg is None:
            raise ValueError("PNA requires the pna_deg degree histogram")

    def _num_radial(self) -> Optional[int]:
        return None


class PNAPlusStack(PNAStack):
    """PNA with a Bessel radial basis of the edge length."""

    def _check(self) -> None:
        cfg = self.cfg
        if cfg.pna_deg is None:
            raise ValueError("PNAPlus requires the pna_deg degree histogram")
        if cfg.radius is None or cfg.num_radial is None:
            raise ValueError("PNAPlus requires radius and num_radial")

    def _num_radial(self) -> Optional[int]:
        return self.cfg.num_radial

    def embed(self, batch):
        if batch.pos is None:
            raise ValueError("PNA+ requires node positions")
        cfg = self.cfg
        _, dist = edge_vectors_and_lengths(
            batch.pos, batch.senders.long(), batch.receivers.long(), batch.edge_shifts
        )
        d = dist / cfg.radius
        freq = torch.arange(
            1, cfg.num_radial + 1, dtype=dist.dtype, device=dist.device
        ) * math.pi
        env = envelope(d, cfg.envelope_exponent or 5)
        rbf = env[:, None] * torch.sin(freq * d[:, None])
        return batch.x, batch.pos, {"rbf": rbf}

    def conv(self, i, inv, equiv, batch, extras):
        return getattr(self, f"conv_{i}")(inv, batch, rbf=extras["rbf"]), equiv
