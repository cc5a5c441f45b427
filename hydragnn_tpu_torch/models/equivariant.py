"""Equivariant stacks: EGNN, PaiNN and PNAEq.

Counterpart of ``E_GCL``, ``EGCLStack``, ``PainnMessage``,
``PainnUpdate``, ``_PainnLayout``, ``PAINNStack``, ``PNAEqMessage`` and
``PNAEqStack`` in ``hydragnn_tpu/models/equivariant.py``.

EGNN (``E_GCL`` per layer): an edge MLP of [x_s, x_r, |d|] (and edge
attributes), summed at the senders (``segment_sum``, the plain scatter:
EGNN's sums run at the senders and never reach K1) into a node MLP of
[x, sum]; under ``equivariance`` every layer but the last also moves the
positions by the sender-side mean of the unit displacements gated by
``tanh(coord_gate(relu(coord_dense(edge))))``, the gate's kernel drawn
from flax's variance_scaling(1e-6, fan_avg, uniform). The positions are
the stack's equivariant channel.

PaiNN: each layer holds a scalar channel ``s`` [N, F] and a vector
channel ``v`` [N, 3, F]:

- the message: a sinc radial basis of the edge length times the cosine
  cutoff filters the sender's scalar MLP, split into three gates (the
  vector-state gate, the edge-direction gate, the scalar message); both
  messages go to the receivers through ``aggregate_receivers``, the
  vector message with its 3-axis folded into the features ([E, 3F]) so
  it reaches K1 as one call;
- the update: U/V maps of the vector channel mixed with the scalar
  channel through the norm of V v and the inner product of U v and V v;
- a tanh MLP and a linear map resize both channels to the hidden width.

The vector-channel Denses have no bias, as in the JAX package: a bias on
``[N, 3, F]`` adds a fixed lab-frame direction that does not rotate with
the input.

PNAEq keeps PaiNN's layout (update and resize) and replaces the message
(``PNAEqMessage``): the scalar message reaches the receivers through
PNA's four aggregators and five degree scalers (the moment pass one K1
call of width 2F, min and max one ``segment_min``), the vector message
as PaiNN's does. Per forward that is two K1 calls a layer, and an MLIP
train step runs each again as K2 in the force pass and as K1/K2 in the
loss's backward, as PaiNN's does.

Submodules carry the flax names (``conv_{i}/edge_mlp``,
``message_{i}``, ``update_{i}``, ``node_embed_out_{i}``,
``vec_embed_out_{i}``; PNAEq's ``message_{i}/rbf_emb``, ``pre_nn``,
``scalar_mlp_{0,1,2}``, ``rbf_lin``, ``post_nn``, ``edge_encoder``), so
``models/convert.params_from_jax`` maps a flax EGNN, PaiNN or PNAEq
tree as it is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.models.layers import MLP, Dense
from hydragnn_tpu_torch.models.pna import _deg_stats, pna_scaled_aggregate
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.rbf import (
    cosine_cutoff,
    edge_vectors_and_lengths,
    sinc_basis,
)
from hydragnn_tpu_torch.ops.segment import aggregate_receivers, segment_mean, segment_sum


class CoordGate(Dense):
    """The coordinate gate's Dense (hidden -> 1, no bias), drawn from
    flax's variance_scaling(1e-6, "fan_avg", "uniform")."""

    def flax_init(self, name: str, p: torch.Tensor, gen: torch.Generator) -> None:
        fan_out, fan_in = p.shape
        limit = math.sqrt(3.0 * 1e-6 / ((fan_in + fan_out) / 2.0))
        p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * limit)


class E_GCL(nn.Module):
    """One E(n)-equivariant graph conv layer: (x [N, in], pos [N, 3]) ->
    (x [N, out], pos)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 edge_dim: Optional[int] = None, equivariant: bool = False):
        super().__init__()
        self.edge_dim = edge_dim
        self.equivariant = equivariant
        self.edge_mlp = MLP(2 * in_dim + 1 + (edge_dim or 0), (hidden_dim, hidden_dim),
                            act="relu", final_activation=True)
        if equivariant:
            self.coord_dense = Dense(hidden_dim, hidden_dim)
            self.coord_gate = CoordGate(hidden_dim, 1, bias=False)
        self.node_mlp = MLP(in_dim + hidden_dim, (hidden_dim, out_dim), act="relu")

    def forward(self, x, pos, batch):
        snd, rcv = batch.senders.long(), batch.receivers.long()
        unit, length = edge_vectors_and_lengths(
            pos, snd, rcv, batch.edge_shifts, normalize=True, eps=1.0
        )
        parts = [x[snd], x[rcv], length[:, None]]
        if self.edge_dim and batch.edge_attr is not None:
            parts.append(batch.edge_attr)
        edge_feat = self.edge_mlp(torch.cat(parts, dim=-1))
        n = batch.num_nodes
        if self.equivariant:
            gate = self.coord_gate(torch.relu(self.coord_dense(edge_feat)))
            trans = torch.clamp(unit * torch.tanh(gate), -100.0, 100.0)
            pos = pos + segment_mean(trans, snd, n, mask=batch.edge_mask)
        agg = segment_sum(edge_feat, snd, n, mask=batch.edge_mask)
        out = self.node_mlp(torch.cat([x, agg], dim=-1))
        return out, pos


class EGCLStack(nn.Module):
    """EGNN stack: ``conv_{i}`` E_GCL layers at ``hidden_dim``, the
    coordinate update on every layer but the last under
    ``equivariance``."""

    norm_kind = "none"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        layers = cfg.num_conv_layers
        for i in range(layers):
            self.add_module(f"conv_{i}", E_GCL(
                cfg.input_dim if i == 0 else cfg.hidden_dim, cfg.hidden_dim,
                cfg.hidden_dim, cfg.edge_dim, cfg.equivariance and i != layers - 1,
            ))

    def embed(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        if batch.pos is None:
            raise ValueError("EGNN requires node positions")
        return batch.x, batch.pos, {}

    def conv(self, i, inv, equiv, batch, extras):
        return getattr(self, f"conv_{i}")(inv, equiv, batch)


class PainnMessage(nn.Module):
    """PaiNN message block."""

    def __init__(
        self,
        node_size: int,
        num_radial: int,
        cutoff: float,
        edge_dim: Optional[int] = None,
    ):
        super().__init__()
        f = node_size
        self.node_size = f
        self.num_radial = num_radial
        self.cutoff = float(cutoff)
        self.filter_layer = Dense(num_radial, 3 * f)
        self.edge_filter = (
            MLP(edge_dim, (f, 3 * f), act="silu") if edge_dim else None
        )
        self.scalar_message_mlp = MLP(f, (f, 3 * f), act="silu")

    def forward(
        self,
        s: torch.Tensor,
        v: torch.Tensor,
        batch,
        unit: torch.Tensor,
        dist: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        snd = batch.senders
        f = self.node_size
        rbf = sinc_basis(dist, self.cutoff, self.num_radial)
        filt = self.filter_layer(rbf) * cosine_cutoff(dist, self.cutoff)[:, None]
        if self.edge_filter is not None and batch.edge_attr is not None:
            filt = filt * self.edge_filter(batch.edge_attr)
        filter_out = filt * self.scalar_message_mlp(s)[snd]
        gate_v, gate_e, msg_s = torch.split(filter_out, f, dim=-1)
        # The displacement is already unit length and is divided by the
        # distance again, as in the reference (PAINNStack.py:255-258).
        direction = unit / torch.clamp(dist, min=1e-9)[:, None]
        msg_v = v[snd] * gate_v[:, None, :] + gate_e[:, None, :] * direction[:, :, None]
        n = batch.num_nodes
        # K1 takes contiguous rows: msg_s is a column slice of
        # filter_out. The vector message folds [E, 3, F] to [E, 3F] (a
        # view), so both channels are one K1 call each.
        s = s + aggregate_receivers(msg_s.contiguous(), batch)
        e, _, fv = msg_v.shape
        v = v + aggregate_receivers(msg_v.reshape(e, 3 * fv), batch).reshape(n, 3, fv)
        return s, v


class PainnUpdate(nn.Module):
    """PaiNN update block; the last layer updates the scalar channel
    only."""

    def __init__(self, node_size: int, last_layer: bool = False):
        super().__init__()
        f = node_size
        self.node_size = f
        self.last_layer = last_layer
        self.update_U = Dense(f, f, bias=False)
        self.update_V = Dense(f, f, bias=False)
        self.update_mlp = MLP(2 * f, (f, 2 * f if last_layer else 3 * f), act="silu")

    def forward(
        self, s: torch.Tensor, v: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.node_size
        uv = self.update_U(v)
        vv = self.update_V(v)
        vv_norm = torch.sqrt(torch.sum(vv * vv, dim=1) + 1e-12)
        mlp_out = self.update_mlp(torch.cat([vv_norm, s], dim=-1))
        inner = torch.sum(uv * vv, dim=1)
        if self.last_layer:
            a_sv, a_ss = torch.split(mlp_out, f, dim=-1)
            return s + a_sv * inner + a_ss, v
        a_vv, a_sv, a_ss = torch.split(mlp_out, f, dim=-1)
        return s + a_sv * inner + a_ss, v + a_vv[:, None, :] * uv


class PNAEqMessage(nn.Module):
    """PaiNN's message with PNA's aggregators on the scalar channel: the
    edge input [s_snd, s_rcv, tanh(rbf_emb(rbf))] (and the encoded edge
    attributes) through ``pre_nn`` and a Dense-tanh-Dense-silu-Dense(3F)
    MLP, gated by ``rbf_lin(rbf)`` into (vector-state gate,
    edge-direction gate, scalar message). The scalar message goes
    through ``pna_scaled_aggregate`` (mean, min, max, std times five
    degree scalers, the moment pass one K1 call of width 2F on a planned
    batch) into ``post_nn``; the vector message, folded to [E, 3F], is
    one K1 call."""

    def __init__(
        self,
        node_size: int,
        num_radial: int,
        cutoff: float,
        avg_deg_lin: float,
        avg_deg_log: float,
        edge_dim: Optional[int] = None,
    ):
        super().__init__()
        f = node_size
        self.node_size = f
        self.num_radial = num_radial
        self.cutoff = float(cutoff)
        self.avg_deg_lin = avg_deg_lin
        self.avg_deg_log = avg_deg_log
        self.rbf_emb = Dense(num_radial, f)
        self.edge_encoder = Dense(edge_dim, f) if edge_dim else None
        self.pre_nn = Dense((4 if edge_dim else 3) * f, f)
        self.scalar_mlp_0 = Dense(f, f)
        self.scalar_mlp_1 = Dense(f, f)
        self.scalar_mlp_2 = Dense(f, 3 * f)
        self.rbf_lin = Dense(num_radial, 3 * f, bias=False)
        self.post_nn = Dense(f + 20 * f, f)

    def forward(
        self,
        s: torch.Tensor,
        v: torch.Tensor,
        batch,
        unit: torch.Tensor,
        dist: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        snd, rcv = batch.senders, batch.receivers
        f = self.node_size
        rbf = sinc_basis(dist, self.cutoff, self.num_radial)
        rbf = rbf * cosine_cutoff(dist, self.cutoff)[:, None]
        parts = [s[snd], s[rcv], torch.tanh(self.rbf_emb(rbf))]
        if self.edge_encoder is not None and batch.edge_attr is not None:
            parts.append(self.edge_encoder(batch.edge_attr))
        msg = self.pre_nn(torch.cat(parts, dim=-1))
        x = torch.tanh(self.scalar_mlp_0(msg))
        x = F.silu(self.scalar_mlp_1(x))
        filter_out = self.scalar_mlp_2(x) * self.rbf_lin(rbf)
        gate_v, gate_e, msg_s = torch.split(filter_out, f, dim=-1)
        msg_v = v[snd] * gate_v[:, None, :] + gate_e[:, None, :] * unit[:, :, None]
        scaled = pna_scaled_aggregate(
            msg_s, batch, self.avg_deg_lin, self.avg_deg_log, inverse_linear=True
        )
        s = s + self.post_nn(torch.cat([s, scaled], dim=-1))
        n = batch.num_nodes
        e, _, fv = msg_v.shape
        v = v + aggregate_receivers(msg_v.reshape(e, 3 * fv), batch).reshape(n, 3, fv)
        return s, v


class _PainnLayout(nn.Module):
    """The PaiNN layout shared by PaiNN and PNAEq: per layer a message
    (``_make_message``), the update, and a tanh MLP and a linear map
    resizing both channels to ``hidden_dim``. Layer 0 runs at the input
    width, the others at ``hidden_dim``; under global attention every
    layer runs at ``hidden_dim`` and the messages read the GPS
    embedding's hidden-wide edge attributes."""

    norm_kind = "none"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.radius is None or cfg.num_radial is None:
            raise ValueError(f"{type(self).__name__} requires radius and num_radial")
        self.cfg = cfg
        layers = cfg.num_conv_layers
        if cfg.use_global_attn:
            in_dims = [cfg.hidden_dim] * layers
        else:
            in_dims = [cfg.input_dim] + [cfg.hidden_dim] * (layers - 1)
        edge_dim = cfg.hidden_dim if cfg.use_global_attn else cfg.edge_dim
        for i in range(layers):
            self.add_module(f"message_{i}", self._make_message(in_dims[i], edge_dim))
            self.add_module(
                f"update_{i}", PainnUpdate(in_dims[i], last_layer=i == layers - 1)
            )
            self.add_module(
                f"node_embed_out_{i}",
                MLP(in_dims[i], (cfg.hidden_dim, cfg.hidden_dim), act="tanh"),
            )
            if i < layers - 1:
                self.add_module(
                    f"vec_embed_out_{i}", Dense(in_dims[i], cfg.hidden_dim, bias=False)
                )

    def embed(
        self, batch
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        if batch.pos is None:
            raise ValueError(f"{type(self).__name__} requires node positions")
        unit, dist = edge_vectors_and_lengths(
            batch.pos, batch.senders, batch.receivers, batch.edge_shifts,
            normalize=True,
        )
        x = batch.x
        v = torch.zeros((x.shape[0], 3, x.shape[-1]), dtype=x.dtype, device=x.device)
        return x, v, {"unit": unit, "dist": dist}

    def conv(
        self,
        i: int,
        inv: torch.Tensor,
        equiv: Optional[torch.Tensor],
        batch,
        extras: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        s, v = getattr(self, f"message_{i}")(
            inv, equiv, batch, extras["unit"], extras["dist"]
        )
        s, v = getattr(self, f"update_{i}")(s, v)
        s = getattr(self, f"node_embed_out_{i}")(s)
        if i < self.cfg.num_conv_layers - 1:
            v = getattr(self, f"vec_embed_out_{i}")(v)
        return s, v


class PAINNStack(_PainnLayout):
    """PaiNN: the layout with ``PainnMessage``."""

    def _make_message(self, node_size: int, edge_dim: Optional[int]) -> nn.Module:
        cfg = self.cfg
        return PainnMessage(node_size, cfg.num_radial, cfg.radius, edge_dim)


class PNAEqStack(_PainnLayout):
    """PNAEq: the layout with ``PNAEqMessage``, its degree statistics
    from the config's ``pna_deg`` histogram."""

    def _make_message(self, node_size: int, edge_dim: Optional[int]) -> nn.Module:
        cfg = self.cfg
        if cfg.pna_deg is None:
            raise ValueError("PNAEq requires the pna_deg degree histogram")
        avg_lin, avg_log = _deg_stats(cfg.pna_deg)
        return PNAEqMessage(node_size, cfg.num_radial, cfg.radius, avg_lin, avg_log, edge_dim)
