"""DimeNet++: directional message passing over angular triplets.

Counterpart of ``hydragnn_tpu/models/dimenet.py``: ``ResidualLayer``,
``EmbeddingBlock``, ``InteractionPPBlock``, ``OutputPPBlock`` and
``DIMEStack``. Per layer a linear node projection, an embedding block
mixing (x_i, x_j, rbf) into edge messages, an interaction block that
passes messages from edge k->j to edge j->i weighted by a spherical
basis of (distance, angle), and an output block summing edges back into
nodes. The triplets (``t_kj``, ``t_ji``, ``triplet_mask``) are built on
the host at collate time (``data/graph.fill_triplets``); the bases are
``ops/sbf.py``'s, with the Chebyshev table a non-persistent float64
buffer (``sbf_cheb``) that ``.to(device)`` carries to the card.

The two sums (triplets into edges, edges into nodes) are the plain
masked ``segment_sum``, as in the JAX package: no K1/K2 on this path.

Row gathers by edge or triplet index go through ``gather_rows``
(``index_select``): the backward of ``x[idx]`` is a sorted
``index_put_`` that walks equal indices one after another, and every
padding triplet indexes the last edge slot (up to a fifth of a batch's
triplets), every padding edge the padding node. ``index_select``'s
backward sums with ``index_add_`` instead; the values are the same.

The angle at node i between i->j and i->k is composed from edge vectors
(v_ki = v_kj + v_ji), so periodic shifts hold. Submodules carry the flax
names (``lin_{i}``, ``emb_{i}``, ``inter_{i}``, ``out_{i}``), so
``models/convert.params_from_jax`` maps a flax DimeNet tree as it is.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hydragnn_tpu_torch.models.layers import Dense
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.rbf import edge_vectors_and_lengths
from hydragnn_tpu_torch.ops.sbf import (
    _radial_cheb_coeffs,
    bessel_basis_envelope,
    spherical_basis,
)
from hydragnn_tpu_torch.ops.segment import segment_sum

ACT = F.silu


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along rows, with a backward that does not serialize on
    repeated indices (module docstring)."""
    return x.index_select(0, idx)


class ResidualLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lin1 = Dense(dim, dim)
        self.lin2 = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + ACT(self.lin2(ACT(self.lin1(x))))


class EmbeddingBlock(nn.Module):
    """Edge messages from the endpoints' features and the radial basis."""

    def __init__(self, hidden_dim: int, num_radial: int, edge_in: Optional[int] = None):
        super().__init__()
        self.lin_rbf = Dense(num_radial, hidden_dim)
        self.edge_in = edge_in
        if edge_in:
            self.edge_lin = Dense(edge_in, hidden_dim)
        self.lin = Dense((4 if edge_in else 3) * hidden_dim, hidden_dim)

    def forward(self, x, rbf, batch, edge_attr):
        parts = [gather_rows(x, batch.receivers), gather_rows(x, batch.senders),
                 ACT(self.lin_rbf(rbf))]
        if self.edge_in and edge_attr is not None:
            parts.append(ACT(self.edge_lin(edge_attr)))
        return ACT(self.lin(torch.cat(parts, dim=-1)))


class InteractionPPBlock(nn.Module):
    """DimeNet++ interaction: each triplet's k->j message, scaled by its
    projected spherical basis, summed into edge j->i."""

    def __init__(self, hidden_dim: int, int_emb_size: int, basis_emb_size: int,
                 num_radial: int, num_spherical: int, num_before_skip: int,
                 num_after_skip: int):
        super().__init__()
        h, i = hidden_dim, int_emb_size
        self.lin_ji = Dense(h, h)
        self.lin_kj = Dense(h, h)
        self.lin_rbf1 = Dense(num_radial, basis_emb_size, bias=False)
        self.lin_rbf2 = Dense(basis_emb_size, h, bias=False)
        self.lin_down = Dense(h, i)
        self.lin_sbf1 = Dense(num_spherical * num_radial, basis_emb_size, bias=False)
        self.lin_sbf2 = Dense(basis_emb_size, i, bias=False)
        self.lin_up = Dense(i, h)
        self.num_before_skip = num_before_skip
        self.num_after_skip = num_after_skip
        for k in range(num_before_skip):
            self.add_module(f"before_skip_{k}", ResidualLayer(h))
        self.lin = Dense(h, h)
        for k in range(num_after_skip):
            self.add_module(f"after_skip_{k}", ResidualLayer(h))

    def forward(self, m, rbf, sbf, batch):
        x_ji = ACT(self.lin_ji(m))
        x_kj = ACT(self.lin_kj(m)) * self.lin_rbf2(self.lin_rbf1(rbf))
        x_kj = ACT(self.lin_down(x_kj))
        sbf_p = self.lin_sbf2(self.lin_sbf1(sbf))
        trip = gather_rows(x_kj, batch.t_kj) * sbf_p
        x_kj = segment_sum(trip, batch.t_ji, m.shape[0], mask=batch.triplet_mask)
        h = x_ji + ACT(self.lin_up(x_kj))
        for k in range(self.num_before_skip):
            h = getattr(self, f"before_skip_{k}")(h)
        h = ACT(self.lin(h)) + m
        for k in range(self.num_after_skip):
            h = getattr(self, f"after_skip_{k}")(h)
        return h


class OutputPPBlock(nn.Module):
    """Edges to nodes: the radial-gated messages summed at the
    receivers, lifted and passed through ``num_layers`` silu layers."""

    def __init__(self, hidden_dim: int, num_radial: int, out_emb_size: int,
                 out_dim: int, num_layers: int = 1):
        super().__init__()
        self.lin_rbf = Dense(num_radial, hidden_dim, bias=False)
        self.lin_up = Dense(hidden_dim, out_emb_size, bias=False)
        self.num_layers = num_layers
        for k in range(num_layers):
            self.add_module(f"lin_{k}", Dense(out_emb_size, out_emb_size))
        self.lin_out = Dense(out_emb_size, out_dim, bias=False)

    def forward(self, m, rbf, batch):
        node = segment_sum(self.lin_rbf(rbf) * m, batch.receivers, batch.num_nodes,
                           mask=batch.edge_mask)
        node = self.lin_up(node)
        for k in range(self.num_layers):
            node = ACT(getattr(self, f"lin_{k}")(node))
        return self.lin_out(node)


class DIMEStack(nn.Module):
    """Stack of DimeNet++ blocks under the multihead core; sizes the
    config leaves unset take DimeNet++'s defaults (``sizes``)."""

    norm_kind = "none"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.radius is None:
            raise ValueError("DimeNet requires radius")
        self.cfg = cfg
        s = self.sizes = self._sizes(cfg)
        self.register_buffer(
            "sbf_cheb",
            torch.tensor(_radial_cheb_coeffs(s["num_spherical"], s["num_radial"])),
            persistent=False,
        )
        in_dim = cfg.hidden_dim if cfg.use_global_attn else cfg.input_dim
        edge_in = None
        if cfg.edge_dim:  # the GPS embedding lifts edge_attr to hidden_dim
            edge_in = cfg.hidden_dim if cfg.use_global_attn else cfg.edge_dim
        for i in range(cfg.num_conv_layers):
            d_in = in_dim if i == 0 else cfg.hidden_dim
            hidden = cfg.hidden_dim if d_in == 1 else d_in
            self.add_module(f"lin_{i}", Dense(d_in, hidden))
            self.add_module(f"emb_{i}", EmbeddingBlock(hidden, s["num_radial"], edge_in))
            self.add_module(f"inter_{i}", InteractionPPBlock(
                hidden, s["int_emb_size"], s["basis_emb_size"], s["num_radial"],
                s["num_spherical"], s["num_before_skip"], s["num_after_skip"],
            ))
            self.add_module(f"out_{i}", OutputPPBlock(
                hidden, s["num_radial"], s["out_emb_size"], cfg.hidden_dim))

    @staticmethod
    def _sizes(cfg: ModelConfig) -> Dict[str, int]:
        def d(v, default):
            return default if v is None else v

        return dict(
            num_radial=d(cfg.num_radial, 6),
            num_spherical=d(cfg.num_spherical, 7),
            envelope_exponent=d(cfg.envelope_exponent, 5),
            basis_emb_size=d(cfg.basis_emb_size, 8),
            int_emb_size=d(cfg.int_emb_size, 64),
            out_emb_size=d(cfg.out_emb_size, 16),
            num_before_skip=d(cfg.num_before_skip, 1),
            num_after_skip=d(cfg.num_after_skip, 2),
        )

    def embed(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        cfg, s = self.cfg, self.sizes
        if batch.pos is None:
            raise ValueError("DimeNet requires node positions")
        if batch.t_kj is None:
            raise ValueError(
                "DimeNet requires triplets; build batches with "
                "with_triplets=True (GraphLoader/PadSpec)"
            )
        vec, dist = edge_vectors_and_lengths(
            batch.pos, batch.senders, batch.receivers, batch.edge_shifts
        )
        v_ji = gather_rows(vec, batch.t_ji)  # pos_j - pos_i
        v_ki = gather_rows(vec, batch.t_kj) + v_ji  # pos_k - pos_i
        a = torch.sum(v_ji * v_ki, dim=-1)
        b = torch.linalg.vector_norm(torch.linalg.cross(v_ji, v_ki), dim=-1)
        angle = torch.arctan2(b, a)
        rbf = bessel_basis_envelope(dist, cfg.radius, s["num_radial"],
                                    s["envelope_exponent"])
        sbf = spherical_basis(
            dist, angle, batch.t_kj, self.sbf_cheb, cutoff=cfg.radius,
            num_spherical=s["num_spherical"], num_radial=s["num_radial"],
            envelope_exponent=s["envelope_exponent"],
        )
        return batch.x, batch.pos, {"rbf": rbf, "sbf": sbf}

    def conv(self, i, inv, equiv, batch, extras):
        rbf, sbf = extras["rbf"], extras["sbf"]
        x = getattr(self, f"lin_{i}")(inv)
        m = getattr(self, f"emb_{i}")(x, rbf, batch, batch.edge_attr)
        m = getattr(self, f"inter_{i}")(m, rbf, sbf, batch)
        return getattr(self, f"out_{i}")(m, rbf, batch), equiv
