"""MACE: the E(3)-equivariant n-body cluster-expansion stack.

Counterpart of ``hydragnn_tpu/models/mace.py``: ``COVALENT_RADII``,
``IrrepsLinear``, ``tp_paths``, ``channelwise_tp``,
``channelwise_tp_aggregate``, ``MACEInteraction``, ``MACELayer`` and
``MACEStack``. Node attributes are the one-hot atomic number over the
118 elements; positions are centred per graph; edges carry real
spherical harmonics of their direction and a Bessel (or Chebyshev or
Gaussian) radial basis times the polynomial cutoff, optionally of an
Agnesi or Soft transform of the length; each layer is the interaction
(up-projection, radial MLP of [radial, down(sender), down(receiver)],
channelwise tensor product with the harmonics, receiver sum, output
linear, linear skip) and the symmetric-contraction product basis.

Layout: equivariant node features are dense [N, C, M] (channel-major,
M = (lmax+1)^2 harmonic components), as in the JAX package. The
receiver sum of a layer is one ``aggregate_receivers`` call on the
contiguous message [E, C * M3] (m innermost), so a planned batch runs
K1 (reduce-only, F = C * M3: 288 at oc20.json's width) and, in the
backward, K2. The per-graph centring is a one-hot matmul
(``segment_mean(..., dense=True)``): no float atomics on the force
path.

The harmonics' coefficients, the coupling tensors and the covalent
radii are non-persistent float64 buffers (cast by the model's
``.to(dtype)``), so the model carries them to the card and a captured
step reads them there. Submodules carry the flax names, so
``models/convert.params_from_jax`` maps a flax MACE tree as it is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hydragnn_tpu_torch.models.layers import MLP, Dense
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.e3 import real_wigner_3j, sh_basis, sh_coeff_matrix, sh_dim
from hydragnn_tpu_torch.ops.rbf import (
    agnesi_transform,
    bessel_basis,
    chebyshev_basis,
    edge_vectors_and_lengths,
    gaussian_smearing,
    polynomial_cutoff,
    soft_transform,
)
from hydragnn_tpu_torch.ops.segment import aggregate_receivers, segment_mean
from hydragnn_tpu_torch.ops.symmetric_contraction import SymmetricContraction

NUM_ELEMENTS = 118

# Covalent radii in Angstrom by atomic number (0 unused): the table the
# Agnesi and Soft transforms read.
COVALENT_RADII = np.array(
    [
        0.20, 0.31, 0.28, 1.28, 0.96, 0.84, 0.76, 0.71, 0.66, 0.57, 0.58,
        1.66, 1.41, 1.21, 1.11, 1.07, 1.05, 1.02, 1.06, 2.03, 1.76, 1.70,
        1.60, 1.53, 1.39, 1.39, 1.32, 1.26, 1.24, 1.32, 1.22, 1.22, 1.20,
        1.19, 1.20, 1.20, 1.16, 2.20, 1.95, 1.90, 1.75, 1.64, 1.54, 1.47,
        1.46, 1.42, 1.39, 1.45, 1.44, 1.42, 1.39, 1.39, 1.38, 1.39, 1.40,
        2.44, 2.15, 2.07, 2.04, 2.03, 2.01, 1.99, 1.98, 1.98, 1.96, 1.94,
        1.92, 1.92, 1.89, 1.90, 1.87, 1.87, 1.75, 1.70, 1.62, 1.51, 1.44,
        1.41, 1.36, 1.36, 1.32, 1.45, 1.46, 1.48, 1.40, 1.50, 1.50, 2.60,
        2.21, 2.15, 2.06, 2.00, 1.96, 1.90, 1.87, 1.80, 1.69, 1.66, 1.68,
        1.68, 1.65, 1.67, 1.73, 1.76, 1.61, 1.57, 1.49, 1.43, 1.41, 1.34,
        1.29, 1.28, 1.21, 1.22, 1.36, 1.43, 1.62, 1.75, 1.65, 1.57,
    ]
)


def _blk(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


class IrrepsLinear(nn.Module):
    """Per-l channel mix [N, C_in, M_in] -> [N, C_out, M_out]: each l
    block present on both sides is ``einsum("nci,co->noi") / sqrt(C_in)``
    with its own ``w{l}`` [C_in, C_out] (flax's layout, drawn from a unit
    normal); an output block the input lacks is zero."""

    def __init__(self, lmax_in: int, lmax_out: int, c_in: int, c_out: int):
        super().__init__()
        self.lmax_in, self.lmax_out, self.c_in, self.c_out = lmax_in, lmax_out, c_in, c_out
        for l in range(min(lmax_in, lmax_out) + 1):
            setattr(self, f"w{l}", nn.Parameter(torch.empty(c_in, c_out)))

    def flax_init(self, name: str, p: torch.Tensor, gen: torch.Generator) -> None:
        """nn.initializers.normal(stddev=1.0)."""
        p.copy_(torch.randn(p.shape, generator=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for l in range(self.lmax_out + 1):
            if l <= self.lmax_in:
                w = getattr(self, f"w{l}")
                dt = torch.promote_types(x.dtype, w.dtype)
                outs.append(torch.einsum("nci,co->noi", x[:, :, _blk(l)].to(dt), w.to(dt))
                            / math.sqrt(self.c_in))
            else:
                outs.append(x.new_zeros((x.shape[0], self.c_out, 2 * l + 1)))
        return torch.cat(outs, dim=-1)


def tp_paths(lmax_node: int, lmax_edge: int, lmax_out: int):
    """Channelwise tensor-product paths (l1, l2, l3)."""
    paths = []
    for l1 in range(lmax_node + 1):
        for l2 in range(lmax_edge + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, lmax_out) + 1):
                paths.append((l1, l2, l3))
    return paths


def _tp_path_blocks(x, sh, weights, paths, lmax_out, cgs=None) -> List[torch.Tensor]:
    """One contraction per path (l1, l2, l3): ``cg[a,b,k] x[e,c,a] sh[e,b]
    w[e,c]`` (the JAX package's four-operand einsum), evaluated as
    ``s = cg . sh`` [E, a, k], then ``x @ s`` [E, C, k] times the weight:
    no intermediate larger than [E, C, 2 l3 + 1]. Accumulated per output
    l3 block and divided by sqrt(paths into the block). ``cgs`` are the
    coupling tensors already on the device, in path order."""
    e, c, _ = x.shape
    counts = np.zeros(lmax_out + 1)
    for _, _, l3 in paths:
        counts[l3] += 1
    out_blocks = [x.new_zeros((e, c, 2 * l + 1)) for l in range(lmax_out + 1)]
    for p, (l1, l2, l3) in enumerate(paths):
        cg = (torch.as_tensor(real_wigner_3j(l1, l2, l3), device=x.device)
              if cgs is None else cgs[p]).to(x.dtype)
        s = torch.einsum("abk,eb->eak", cg, sh[:, _blk(l2)])
        term = torch.bmm(x[:, :, _blk(l1)], s) * weights[:, p, :, None]
        out_blocks[l3] = out_blocks[l3] + term
    return [b / math.sqrt(max(counts[l], 1.0)) for l, b in enumerate(out_blocks)]


def channelwise_tp(x, sh, weights, paths, lmax_out: int, cgs=None) -> torch.Tensor:
    """MACE's 'uvu' tensor product with per-edge weights: x [E, C, M1]
    (gathered sender features), sh [E, M2], weights [E, P, C] ->
    [E, C, M3]."""
    return torch.cat(_tp_path_blocks(x, sh, weights, paths, lmax_out, cgs), dim=-1)


def channelwise_tp_aggregate(x, sh, weights, paths, lmax_out: int, batch,
                             cgs=None) -> torch.Tensor:
    """``channelwise_tp`` and the receiver sum as one op [E, C, M1] ->
    [N, C, M3]: the message is made contiguous as [E, C * M3] (m
    innermost) and summed by one ``aggregate_receivers`` call (K1 on a
    planned batch), whose output reshapes to [N, C, M3]."""
    e, c, _ = x.shape
    mji = torch.cat(_tp_path_blocks(x, sh, weights, paths, lmax_out, cgs), dim=-1)
    return aggregate_receivers(mji.reshape(e, -1).contiguous(), batch).reshape(
        batch.num_nodes, c, -1
    )


class MACEInteraction(nn.Module):
    """The residual interaction block: ``skip_linear``, ``linear_up``,
    the scalar ``linear_down`` feeding the radial MLP
    ``conv_tp_weights`` (3 x radial_dim, then P x C, silu) with the edge
    features, the channelwise tensor product with the edge harmonics
    summed at the receivers and divided by ``avg_num_neighbors``, and the
    output ``linear``. Returns (message [N, C, M_edge], skip [N, C,
    M_hidden])."""

    def __init__(self, channels: int, lmax_node_in: int, lmax_edge: int,
                 lmax_hidden: int, avg_num_neighbors: float, radial_dim: int,
                 edge_feat_dim: int):
        super().__init__()
        c = channels
        self.channels = c
        self.lmax_edge = lmax_edge
        self.avg_num_neighbors = float(avg_num_neighbors)
        self.skip_linear = IrrepsLinear(lmax_node_in, lmax_hidden, c, c)
        self.linear_up = IrrepsLinear(lmax_node_in, lmax_node_in, c, c)
        self.linear_down = Dense(c, c, bias=False)
        self.paths = tp_paths(lmax_node_in, lmax_edge, lmax_edge)
        for p, (l1, l2, l3) in enumerate(self.paths):
            self.register_buffer(f"cg_{p}", torch.as_tensor(real_wigner_3j(l1, l2, l3)),
                                 persistent=False)
        self.conv_tp_weights = MLP(
            edge_feat_dim + 2 * c, (radial_dim,) * 3 + (len(self.paths) * c,),
            act="silu",
        )
        self.linear = IrrepsLinear(lmax_edge, lmax_edge, c, c)

    def forward(self, node_feats, edge_sh, edge_feats, batch):
        c = self.channels
        snd, rcv = batch.senders.long(), batch.receivers.long()
        sc = self.skip_linear(node_feats)
        up = self.linear_up(node_feats)
        down = self.linear_down(node_feats[:, :, 0])
        aug = torch.cat([edge_feats, down[snd], down[rcv]], dim=-1)
        rad = self.conv_tp_weights(aug)
        w = rad.reshape(rad.shape[0], len(self.paths), c)
        w = w * batch.edge_mask[:, None, None].to(w.dtype)
        cgs = [getattr(self, f"cg_{p}") for p in range(len(self.paths))]
        msg = channelwise_tp_aggregate(up[snd], edge_sh, w, self.paths, self.lmax_edge,
                                       batch, cgs)
        msg = msg / self.avg_num_neighbors
        return self.linear(msg), sc


class MACELayer(nn.Module):
    """Interaction, product basis (``SymmetricContraction`` of the
    message with the one-hot), ``product_linear``, the skip, and the
    ``sizing`` linear."""

    def __init__(self, channels: int, lmax_node_in: int, lmax_edge: int,
                 lmax_hidden: int, correlation: int, avg_num_neighbors: float,
                 radial_dim: int, edge_feat_dim: int, use_sc: bool = True):
        super().__init__()
        c = channels
        self.use_sc = use_sc
        self.interaction = MACEInteraction(c, lmax_node_in, lmax_edge, lmax_hidden,
                                           avg_num_neighbors, radial_dim, edge_feat_dim)
        self.product = SymmetricContraction(lmax_edge, lmax_hidden, correlation,
                                            NUM_ELEMENTS, c)
        self.product_linear = IrrepsLinear(lmax_hidden, lmax_hidden, c, c)
        self.sizing = IrrepsLinear(lmax_hidden, lmax_hidden, c, c)

    def forward(self, node_feats, node_onehot, edge_sh, edge_feats, batch):
        msg, sc = self.interaction(node_feats, edge_sh, edge_feats, batch)
        prod = self.product_linear(self.product(msg, node_onehot))
        out = prod + sc if self.use_sc else prod
        return self.sizing(out)


class MACEStack(nn.Module):
    """MACE encoder in the stack protocol (``embed``/``conv``), with
    per-layer readouts summed by the multihead core: ``readout0_input``
    (the one-hot) feeds decoder 0, each layer's scalar channel one more
    decoder. Layer 0 reads l = 0 node features, the last layer writes
    l = 0 only (its ``lmax_hidden`` is 0)."""

    norm_kind = "none"
    inter_layer_activation = False
    per_layer_readouts = True
    readout0_dim = NUM_ELEMENTS

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.radius is None or cfg.num_radial is None:
            raise ValueError("MACE requires radius and num_radial")
        if cfg.max_ell is None or cfg.node_max_ell is None:
            raise ValueError("MACE requires max_ell and node_max_ell")
        if cfg.max_ell < 1 or cfg.node_max_ell < 1:
            raise ValueError("MACE requires max_ell >= 1, node_max_ell >= 1")
        if cfg.radial_type not in (None, "bessel", "chebyshev", "gaussian"):
            raise ValueError(f"Unknown radial_type {cfg.radial_type}")
        self.cfg = cfg
        c = cfg.hidden_dim
        radial_dim = max(1, math.ceil(c / 3.0))
        corr = cfg.correlation if cfg.correlation is not None else 2
        ann = cfg.avg_num_neighbors if cfg.avg_num_neighbors else 1.0
        edge_feat_dim = cfg.num_radial + (cfg.edge_dim or 0)
        for i in range(cfg.num_conv_layers):
            last = i == cfg.num_conv_layers - 1
            self.add_module(f"layer_{i}", MACELayer(
                c, 0 if i == 0 else cfg.node_max_ell, cfg.max_ell,
                0 if last else cfg.node_max_ell, corr, ann, radial_dim, edge_feat_dim,
            ))
        self.node_embedding = Dense(NUM_ELEMENTS, c, bias=False)
        for l in range(1, cfg.max_ell + 1):
            self.register_buffer(f"sh_coeff_{l}", torch.as_tensor(sh_coeff_matrix(l)),
                                 persistent=False)
        self.register_buffer("covalent_radii", torch.as_tensor(COVALENT_RADII),
                             persistent=False)

    def _z(self, batch) -> torch.Tensor:
        """The atomic number (the first input column), clamped to 1..118."""
        return torch.clamp(torch.round(batch.x[:, 0]), 1, NUM_ELEMENTS).long()

    def _onehot(self, batch) -> torch.Tensor:
        """One-hot Z over the periodic table, zero on padding nodes."""
        oh = nn.functional.one_hot(self._z(batch) - 1, NUM_ELEMENTS).to(batch.x.dtype)
        return oh * batch.node_mask[:, None].to(batch.x.dtype)

    def embed(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        cfg = self.cfg
        if batch.pos is None:
            raise ValueError("MACE requires node positions (batch.pos) to be set.")
        ids = batch.node_graph_idx.long()
        mean_pos = segment_mean(batch.pos, ids, batch.num_graphs, mask=batch.node_mask,
                                dense=True)
        pos = batch.pos - mean_pos[ids]
        snd, rcv = batch.senders.long(), batch.receivers.long()
        vec, length = edge_vectors_and_lengths(pos, snd, rcv, batch.edge_shifts)
        coeffs = [getattr(self, f"sh_coeff_{l}") for l in range(1, cfg.max_ell + 1)]
        edge_sh = sh_basis(vec, cfg.max_ell, normalize=True, coeffs=coeffs)
        onehot = self._onehot(batch)

        # The cutoff sees the raw length; the basis the transformed one.
        d = length
        if cfg.distance_transform in ("Agnesi", "Soft"):
            rc = self.covalent_radii.to(d.dtype)[self._z(batch)]
            r_uv = rc[snd] + rc[rcv]
            if cfg.distance_transform == "Agnesi":
                d = agnesi_transform(d, 0.5 * r_uv)
            else:
                d = soft_transform(d, 0.25 * r_uv)
        p = cfg.envelope_exponent if cfg.envelope_exponent else 5
        if cfg.radial_type in (None, "bessel"):
            rb = bessel_basis(d, cfg.radius, cfg.num_radial)
        elif cfg.radial_type == "chebyshev":
            rb = chebyshev_basis(d, cfg.radius, cfg.num_radial)
        else:
            rb = gaussian_smearing(d, 0.0, cfg.radius, cfg.num_radial)
        edge_feats = rb * polynomial_cutoff(length, cfg.radius, p)[:, None]
        if batch.edge_attr is not None:
            edge_feats = torch.cat([edge_feats, batch.edge_attr], dim=-1)
        node_feats = self.node_embedding(onehot)
        extras = {"edge_sh": edge_sh, "edge_feats": edge_feats, "onehot": onehot,
                  "readout0_input": onehot}
        return node_feats, None, extras

    def conv(self, i: int, inv, equiv, batch, extras):
        c = self.cfg.hidden_dim
        if equiv is None or equiv.shape[-1] == 0:
            node_feats = inv[:, :, None]
        else:
            m_in = sh_dim(self.cfg.node_max_ell)
            node_feats = torch.cat([inv[:, :, None], equiv.reshape(-1, c, m_in - 1)], dim=-1)
        out = getattr(self, f"layer_{i}")(node_feats, extras["onehot"], extras["edge_sh"],
                                          extras["edge_feats"], batch)
        return out[:, :, 0], out[:, :, 1:].reshape(out.shape[0], -1)
