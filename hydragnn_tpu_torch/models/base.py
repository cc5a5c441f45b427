"""Multi-headed GNN core: encoder orchestration and multihead decoders.

Counterpart of ``hydragnn_tpu/models/base.py``: ``graph_pool``,
``select_branch``, ``MLPNode``, ``MultiHeadDecoder`` and
``MultiHeadGraphModel``. Graph heads are a per-branch shared MLP plus a
per-head MLP; node heads are MLPs (shared or per node slot); rows are
routed to their branch by ``dataset_id`` as masked dense compute plus a
select, as in the JAX package. Batch-normed stacks (``norm_kind =
"batch"``) get a ``MaskedBatchNorm`` ``feature_norm_{i}`` after every
conv layer, and a GPS config (``global_attn_engine``) lifts the inputs
with ``GPSInputEmbed`` and wraps every conv layer in a ``GPSLayer``, in
the JAX package's order: conv, GPS layer, feature norm, activation.

Not ported yet, and raising ``NotImplementedError`` that names their
ROADMAP item: graph-attribute conditioning (Queue 1 item 8), conv-type
node heads (item 8) and per-layer readouts (MACE, item 9).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Type

import dataclasses

import torch
from torch import nn

from hydragnn_tpu_torch.models.gps import GPSInputEmbed, GPSLayer
from hydragnn_tpu_torch.models.layers import MLP, Dense, MaskedBatchNorm, activation
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.segment import (
    dense_segment_sum,
    segment_max,
    segment_mean,
)


def graph_pool(x: torch.Tensor, batch, mode: str) -> torch.Tensor:
    """Masked graph pooling [N, F] -> [G, F]. Sums are one-hot matmuls
    (``dense_segment_sum``): no float atomics, so the same bits on every
    CUDA run, and no host sync."""
    ids = batch.node_graph_idx
    g = batch.num_graphs
    if mode == "mean":
        return segment_mean(x, ids, g, mask=batch.node_mask, dense=True)
    if mode == "add":
        return dense_segment_sum(x, ids, g, mask=batch.node_mask)
    if mode == "max":
        return segment_max(x, ids, g, mask=batch.node_mask)
    raise ValueError(f"Unsupported graph_pooling: {mode}")


def select_branch(stacked: torch.Tensor, branch_ids: torch.Tensor) -> torch.Tensor:
    """Pick per-row branch outputs: stacked [B, K, D], ids [K] -> [K, D]."""
    k = stacked.shape[1]
    return stacked[branch_ids.long(), torch.arange(k, device=stacked.device)]


class MLPNode(nn.Module):
    """Node-level head MLP; ``per_node`` gives every node slot its own
    weights ``w_{i}`` [num_nodes, in, out] and biases ``b_{i}``."""

    def __init__(
        self,
        in_dim: int,
        hidden_dims: Tuple[int, ...],
        output_dim: int,
        act: str,
        per_node: bool = False,
        num_nodes: Optional[int] = None,
    ):
        super().__init__()
        self.dims = tuple(hidden_dims) + (output_dim,)
        self.act = activation(act)
        self.per_node = per_node
        self.num_nodes = num_nodes
        d = in_dim
        for i, o in enumerate(self.dims):
            if per_node:
                if num_nodes is None:
                    raise ValueError("mlp_per_node requires a fixed num_nodes")
                setattr(self, f"w_{i}", nn.Parameter(torch.empty(num_nodes, d, o)))
                setattr(self, f"b_{i}", nn.Parameter(torch.zeros(num_nodes, o)))
            else:
                self.add_module(f"dense_{i}", Dense(d, o))
            d = o

    def forward(self, x: torch.Tensor, batch, branch_mask=None) -> torch.Tensor:
        last = len(self.dims) - 1
        if not self.per_node:
            for i in range(len(self.dims)):
                x = getattr(self, f"dense_{i}")(x)
                if i < last:
                    x = self.act(x)
            return x
        slot = torch.clamp(batch.node_slot.long(), max=self.num_nodes - 1)
        for i in range(len(self.dims)):
            w = getattr(self, f"w_{i}")[slot]
            x = torch.einsum("nf,nfd->nd", x, w) + getattr(self, f"b_{i}")[slot]
            if i < last:
                x = self.act(x)
        return x


class MultiHeadDecoder(nn.Module):
    """Graph and node heads with branch routing. Submodules carry the
    flax names: ``graph_shared_<branch>``, ``head<i>_<branch>``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.shared_names = []
        for b in cfg.graph_branches:
            name = f"graph_shared_{b.name}"
            self.add_module(
                name,
                MLP(h, (b.dim_sharedlayers,) * b.num_sharedlayers,
                    act=cfg.activation, final_activation=True),
            )
            self.shared_names.append(name)
        self.head_names: List[List[str]] = []
        for hi, head in enumerate(cfg.heads):
            out_dim = head.dim * (1 + cfg.var_output)
            names = []
            if head.type == "graph":
                for b in cfg.graph_branches:
                    name = f"head{hi}_{b.name}"
                    in_dim = b.dim_sharedlayers if b.num_sharedlayers else h
                    self.add_module(
                        name,
                        MLP(in_dim,
                            tuple(b.dim_headlayers[: b.num_headlayers]) + (out_dim,),
                            act=cfg.activation),
                    )
                    names.append(name)
            elif head.type == "node":
                for b in cfg.node_branches:
                    if b.node_head_type not in ("mlp", "mlp_per_node"):
                        if b.node_head_type == "conv":
                            raise NotImplementedError(
                                "conv-type node heads are not ported yet: "
                                "ROADMAP Queue 1 item 8"
                            )
                        raise ValueError(f"Unknown node head type {b.node_head_type}")
                    name = f"head{hi}_{b.name}"
                    self.add_module(
                        name,
                        MLPNode(
                            h,
                            tuple(b.dim_headlayers[: b.num_headlayers]),
                            out_dim,
                            cfg.activation,
                            per_node=b.node_head_type == "mlp_per_node",
                            num_nodes=cfg.num_nodes,
                        ),
                    )
                    names.append(name)
            else:
                raise ValueError(f"Unknown head type {head.type}")
            self.head_names.append(names)

    def forward(
        self, node_repr: torch.Tensor, pooled: torch.Tensor, batch
    ) -> List[torch.Tensor]:
        cfg = self.cfg
        outputs: List[torch.Tensor] = []
        graph_ids = (
            batch.dataset_id
            if batch.dataset_id is not None
            else torch.zeros(batch.num_graphs, dtype=torch.int32, device=pooled.device)
        )
        node_ids = graph_ids[batch.node_graph_idx.long()]
        shared = [getattr(self, n)(pooled) for n in self.shared_names]
        for hi, head in enumerate(cfg.heads):
            mods = [getattr(self, n) for n in self.head_names[hi]]
            if head.type == "graph":
                outs = [m(shared[b]) for b, m in enumerate(mods)]
                ids = graph_ids
            else:
                multi = len(mods) > 1
                outs = [
                    m(node_repr, batch, (node_ids == bi) if multi else None)
                    for bi, m in enumerate(mods)
                ]
                ids = node_ids
            outputs.append(
                outs[0] if len(outs) == 1 else select_branch(torch.stack(outs), ids)
            )
        return outputs


class MultiHeadGraphModel(nn.Module):
    """Encoder stack + multihead decoder, with the GPS layers, feature
    norms and activation between conv layers; ``forward(batch)`` returns
    the list of head outputs. Batch norms use batch statistics and
    update their running statistics in ``train()`` mode, and read the
    running statistics in ``eval()`` mode."""

    def __init__(self, cfg: ModelConfig, stack_cls: Type[nn.Module]):
        super().__init__()
        if cfg.use_graph_attr_conditioning:
            raise NotImplementedError(
                "graph-attribute conditioning is not ported yet: ROADMAP "
                "Queue 1 item 8"
            )
        if getattr(stack_cls, "per_layer_readouts", False):
            raise NotImplementedError(
                "per-layer readouts (MACE) are not ported yet: ROADMAP "
                "Queue 1 item 9"
            )
        self.cfg = cfg
        self.stack_cls = stack_cls
        self.stack = stack_cls(cfg)
        self.decoder = MultiHeadDecoder(cfg)
        layers = range(cfg.num_conv_layers)
        self.norm_layers = getattr(stack_cls, "norm_kind", "none") == "batch"
        if self.norm_layers:
            for i in layers:
                self.add_module(f"feature_norm_{i}", MaskedBatchNorm(cfg.hidden_dim))
        if cfg.use_global_attn:
            self.gps_embed = GPSInputEmbed(cfg)
            for i in layers:
                self.add_module(f"gps_{i}", GPSLayer(cfg))

    def encode(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Embedding + conv layers; returns (node_repr, equiv_feat)."""
        cfg = self.cfg
        act = activation(cfg.activation)
        if cfg.use_global_attn:
            x_emb, e_emb = self.gps_embed(batch)
            batch = dataclasses.replace(
                batch, x=x_emb, edge_attr=batch.edge_attr if e_emb is None else e_emb
            )
        inv, equiv, extras = self.stack.embed(batch)
        use_act = getattr(self.stack_cls, "inter_layer_activation", True)
        for i in range(cfg.num_conv_layers):
            h, equiv = self.stack.conv(i, inv, equiv, batch, extras)
            inv = getattr(self, f"gps_{i}")(inv, h, batch) if cfg.use_global_attn else h
            if self.norm_layers:
                inv = getattr(self, f"feature_norm_{i}")(inv, batch.node_mask)
            if use_act:
                inv = act(inv)
        return inv, equiv

    def forward(self, batch) -> List[torch.Tensor]:
        node_repr, _ = self.encode(batch)
        pooled = graph_pool(node_repr, batch, self.cfg.graph_pooling)
        return self.decoder(node_repr, pooled, batch)
