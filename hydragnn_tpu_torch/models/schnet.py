"""SchNet stack: continuous-filter convolutions with Gaussian smearing.

Counterpart of ``hydragnn_tpu/models/schnet.py`` (``CFConv``,
``SchNetStack``): Gaussian RBF of the edge length, a filter MLP with
shifted softplus, cosine-cutoff weighting, and the edge pipeline
gather -> filter multiply -> ``lin2`` matmul -> receiver sum as one
``aggregate_receivers_pipeline`` call (K1 on a planned batch). The
optional coordinate-update channel recomputes positions between layers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from hydragnn_tpu_torch.models.layers import MLP, Dense, DenseParams
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.rbf import (
    cosine_cutoff,
    edge_vectors_and_lengths,
    gaussian_smearing,
)
from hydragnn_tpu_torch.ops.segment import (
    aggregate_receivers_pipeline,
    segment_mean,
)


class CFConv(nn.Module):
    """One continuous-filter convolution."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        num_filters: int,
        num_gaussians: int,
        cutoff: float,
        edge_dim: Optional[int] = None,
        equivariant: bool = False,
    ):
        super().__init__()
        self.cutoff = float(cutoff)
        self.equivariant = equivariant
        self.filter_mlp = MLP(
            num_gaussians + (edge_dim or 0),
            (num_filters, num_filters),
            act="shifted_softplus",
        )
        self.lin1 = Dense(in_dim, num_filters, bias=False)
        if equivariant:
            self.coord_mlp = MLP(num_filters, (num_filters, 1), act="relu")
        # lin2's matmul runs inside the fused edge pipeline, so it is a
        # DenseParams twin holding the [in, out] kernel; its bias adds
        # after the reduce (sum and matmul commute, the bias does not).
        self.lin2 = DenseParams(num_filters, out_dim)

    def forward(
        self,
        x: torch.Tensor,
        pos: Optional[torch.Tensor],
        batch,
        edge_rbf: torch.Tensor,
        edge_len: torch.Tensor,
        edge_attr: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        snd, rcv = batch.senders, batch.receivers
        c = cosine_cutoff(edge_len, self.cutoff)
        filt_in = (
            edge_rbf if edge_attr is None else torch.cat([edge_rbf, edge_attr], dim=-1)
        )
        w = self.filter_mlp(filt_in) * c[:, None]
        h = self.lin1(x)
        if self.equivariant and pos is not None:
            # Coordinate update: mean of unit displacements scaled by a
            # learned gate of the filter weights, at the sender side.
            vec, _ = edge_vectors_and_lengths(
                pos, snd, rcv, batch.edge_shifts, normalize=True, eps=1.0
            )
            gate = self.coord_mlp(w)
            trans = torch.clamp(vec * gate, -100.0, 100.0)
            pos = pos + segment_mean(
                trans, snd, batch.num_nodes, mask=batch.edge_mask
            )
        w2, b2 = self.lin2()
        out = aggregate_receivers_pipeline(h[snd], w, batch, weight=w2) + b2
        return out, pos


class SchNetStack(nn.Module):
    """Stack of CFConv layers, named ``conv_{i}`` as in flax."""

    norm_kind = "none"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.radius is None or cfg.num_gaussians is None or cfg.num_filters is None:
            raise ValueError("SchNet requires radius, num_gaussians, num_filters")
        self.cfg = cfg
        in_dim = cfg.hidden_dim if cfg.use_global_attn else cfg.input_dim
        for i in range(cfg.num_conv_layers):
            last = i == cfg.num_conv_layers - 1
            self.add_module(
                f"conv_{i}",
                CFConv(
                    in_dim=in_dim if i == 0 else cfg.hidden_dim,
                    out_dim=cfg.hidden_dim,
                    num_filters=cfg.num_filters,
                    num_gaussians=cfg.num_gaussians,
                    cutoff=cfg.radius,
                    edge_dim=cfg.edge_dim,
                    equivariant=cfg.equivariance and not last,
                ),
            )

    def embed(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        return batch.x, batch.pos, {}

    def conv(
        self,
        i: int,
        inv: torch.Tensor,
        equiv: Optional[torch.Tensor],
        batch,
        extras: Dict[str, Any],
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        _, edge_len = edge_vectors_and_lengths(
            equiv, batch.senders, batch.receivers, batch.edge_shifts
        )
        edge_rbf = gaussian_smearing(edge_len, 0.0, cfg.radius, cfg.num_gaussians)
        return getattr(self, f"conv_{i}")(
            inv, equiv, batch, edge_rbf, edge_len, batch.edge_attr
        )
