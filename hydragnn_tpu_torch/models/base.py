"""Multi-headed GNN core: encoder orchestration and multihead decoders.

Counterpart of ``hydragnn_tpu/models/base.py``: ``graph_pool``,
``select_branch``, ``MLPNode``, ``ConvNodeHead``, ``MultiHeadDecoder``,
``GraphAttrConditioner`` and ``MultiHeadGraphModel``. Graph heads are a
per-branch shared MLP plus a per-head MLP; node heads are MLPs (shared
or per node slot) or a chain of convs (``"conv"``); rows are routed to
their branch by ``dataset_id`` as masked dense compute plus a select, as
in the JAX package. Batch-normed stacks (``norm_kind = "batch"``) get a
``MaskedBatchNorm`` ``feature_norm_{i}`` after every conv layer, and a
GPS config (``global_attn_engine``) lifts the inputs with
``GPSInputEmbed`` and wraps every conv layer in a ``GPSLayer``, in the
JAX package's order: conv, GPS layer, graph-attribute conditioning
(``film``/``concat_node``), feature norm, activation; ``fuse_pool``
conditions the pooled graph features instead.

A stack with ``per_layer_readouts`` (MACE) gets one decoder on its
embedding's ``readout0_input`` (``decoder_0``) and one on each conv
layer's scalar channel (``decoder_{i+1}``), their outputs summed, as in
the JAX package; with GPS, the Laplacian PE is lifted by ``gps_pe_lift``
and added to the scalar channel instead of ``GPSInputEmbed``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Type

import dataclasses

import torch
from torch import nn

from hydragnn_tpu_torch.models.gps import GPSInputEmbed, GPSLayer
from hydragnn_tpu_torch.models.layers import (
    MLP,
    Dense,
    DenseParams,
    MaskedBatchNorm,
    activation,
)
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.segment import (
    aggregate_receivers_pipeline,
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


class ConvNodeHead(nn.Module):
    """Node head of message-passing layers: for each width ``d`` of
    ``hidden_dims + (output_dim,)``, ``self_{i}(x) + mean over incoming
    edges of x_snd @ neigh_{i}``, then ``MaskedBatchNorm`` ``bn_{i}`` over
    this branch's real nodes, and the activation on all but the last
    layer. The neighbour term is one call of the fused edge pipeline (K1
    in its a,W flavour on a planned batch, K2 as its backward), with the
    mean's degree scale applied after the sum; ``neigh_{i}`` is a
    ``DenseParams`` whose ``[in, out]`` kernel is K1's W."""

    def __init__(self, in_dim: int, hidden_dims: Tuple[int, ...], output_dim: int,
                 act: str):
        super().__init__()
        self.dims = tuple(hidden_dims) + (output_dim,)
        self.act = activation(act)
        d_in = in_dim
        for i, d in enumerate(self.dims):
            self.add_module(f"neigh_{i}", DenseParams(d_in, d, use_bias=False))
            self.add_module(f"self_{i}", Dense(d_in, d))
            self.add_module(f"bn_{i}", MaskedBatchNorm(d))
            d_in = d

    def forward(self, x: torch.Tensor, batch, branch_mask=None) -> torch.Tensor:
        # batch statistics come from this branch's real nodes only
        bn_mask = batch.node_mask if branch_mask is None else batch.node_mask & branch_mask
        snd = batch.senders.long()
        last = len(self.dims) - 1
        for i in range(len(self.dims)):
            w_n, _ = getattr(self, f"neigh_{i}")()
            neigh = aggregate_receivers_pipeline(x[snd], None, batch, weight=w_n, mean=True)
            x = getattr(self, f"self_{i}")(x) + neigh
            x = getattr(self, f"bn_{i}")(x, bn_mask)
            if i < last:
                x = self.act(x)
        return x


class MultiHeadDecoder(nn.Module):
    """Graph and node heads with branch routing. Submodules carry the
    flax names: ``graph_shared_<branch>``, ``head<i>_<branch>``."""

    def __init__(self, cfg: ModelConfig, in_dim: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim if in_dim is None else in_dim
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
                    hidden = tuple(b.dim_headlayers[: b.num_headlayers])
                    if b.node_head_type in ("mlp", "mlp_per_node"):
                        head_mod = MLPNode(
                            h, hidden, out_dim, cfg.activation,
                            per_node=b.node_head_type == "mlp_per_node",
                            num_nodes=cfg.num_nodes,
                        )
                    elif b.node_head_type == "conv":
                        head_mod = ConvNodeHead(h, hidden, out_dim, cfg.activation)
                    else:
                        raise ValueError(f"Unknown node head type {b.node_head_type}")
                    name = f"head{hi}_{b.name}"
                    self.add_module(name, head_mod)
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


class GraphAttrConditioner(nn.Module):
    """Conditioning on the per-graph attributes ``graph_attr`` [G, Da]:
    ``film`` scales and shifts features by ``x * (1 + gamma) + beta``
    from a one-layer MLP ``film`` of the attributes; ``concat_node`` and
    ``fuse_pool`` project ``[x, attr]`` back to the width with the Dense
    ``proj``. One module serves every layer (and the pool), as in the JAX
    package, so every input it sees is ``features`` wide."""

    def __init__(self, features: int, attr_dim: int, mode: str, act: str):
        super().__init__()
        if mode not in ("film", "concat_node", "fuse_pool"):
            raise ValueError(
                "graph_attr_conditioning_mode must be film, concat_node, or "
                f"fuse_pool; got {mode}"
            )
        if attr_dim <= 0:
            raise ValueError(
                "graph-attribute conditioning needs Architecture.graph_attr_dim, "
                "the width of each sample's graph_attr"
            )
        self.mode = mode
        if mode == "film":
            self.film = MLP(attr_dim, (2 * features,), act=act)
        else:
            self.proj = Dense(features + attr_dim, features)

    def forward(self, x: torch.Tensor, graph_attr: torch.Tensor,
                graph_idx: Optional[torch.Tensor]) -> torch.Tensor:
        if self.mode == "film":
            gamma, beta = torch.chunk(self.film(graph_attr), 2, dim=-1)
            if graph_idx is not None:
                gamma, beta = gamma[graph_idx], beta[graph_idx]
            return x * (1.0 + gamma) + beta
        attr = graph_attr if graph_idx is None else graph_attr[graph_idx]
        dt = torch.promote_types(x.dtype, attr.dtype)
        return self.proj(torch.cat([x.to(dt), attr.to(dt)], dim=-1))


class MultiHeadGraphModel(nn.Module):
    """Encoder stack + multihead decoder, with the GPS layers, feature
    norms and activation between conv layers; ``forward(batch)`` returns
    the list of head outputs. Batch norms use batch statistics and
    update their running statistics in ``train()`` mode, and read the
    running statistics in ``eval()`` mode."""

    def __init__(self, cfg: ModelConfig, stack_cls: Type[nn.Module]):
        super().__init__()
        self.cfg = cfg
        self.stack_cls = stack_cls
        self.stack = stack_cls(cfg)
        self.per_layer_readouts = getattr(stack_cls, "per_layer_readouts", False)
        layers = range(cfg.num_conv_layers)
        if self.per_layer_readouts:
            # decoder_0 reads the embedding's readout0_input (MACE: the
            # 118-wide one-hot), the others a layer's scalar channel
            self.add_module("decoder_0", MultiHeadDecoder(cfg, self.stack.readout0_dim))
            for i in layers:
                self.add_module(f"decoder_{i + 1}", MultiHeadDecoder(cfg))
        else:
            self.decoder = MultiHeadDecoder(cfg)
        self.norm_layers = getattr(stack_cls, "norm_kind", "none") == "batch"
        if self.norm_layers:
            for i in layers:
                self.add_module(f"feature_norm_{i}",
                                MaskedBatchNorm(self.stack.conv_out_dim(i)))
        if cfg.use_global_attn:
            if self.per_layer_readouts:
                self.gps_pe_lift = Dense(cfg.pe_dim, cfg.hidden_dim, bias=False)
            else:
                self.gps_embed = GPSInputEmbed(cfg)
            for i in layers:
                self.add_module(f"gps_{i}", GPSLayer(cfg))
        self.conditioning = (
            cfg.graph_attr_conditioning_mode if cfg.use_graph_attr_conditioning else None
        )
        if self.conditioning:
            self.graph_conditioner = GraphAttrConditioner(
                cfg.hidden_dim, cfg.graph_attr_dim, self.conditioning, cfg.activation
            )

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
            inv = self._condition_inv(inv, batch)
            if self.norm_layers:
                inv = getattr(self, f"feature_norm_{i}")(inv, batch.node_mask)
            if use_act:
                inv = act(inv)
        return inv, equiv

    def _condition_inv(self, inv: torch.Tensor, batch) -> torch.Tensor:
        if self.conditioning in ("film", "concat_node") and batch.graph_attr is not None:
            return self.graph_conditioner(inv, batch.graph_attr, batch.node_graph_idx.long())
        return inv

    def _decode(self, decoder, node_repr: torch.Tensor, batch) -> List[torch.Tensor]:
        pooled = graph_pool(node_repr, batch, self.cfg.graph_pooling)
        if self.conditioning == "fuse_pool" and batch.graph_attr is not None:
            pooled = self.graph_conditioner(pooled, batch.graph_attr, None)
        return decoder(node_repr, pooled, batch)

    def _forward_per_layer_readouts(self, batch) -> List[torch.Tensor]:
        """Decoder 0 on the embedding's ``readout0_input`` plus one
        decoder per conv layer on its scalar channel, summed."""
        cfg = self.cfg
        inv, equiv, extras = self.stack.embed(batch)
        read0 = extras.get("readout0_input", inv)
        if cfg.use_global_attn:
            if batch.pe is None:
                raise ValueError(
                    "GPS global attention requires Laplacian PE; set pe_dim>0 so "
                    "the data pipeline attaches batch.pe"
                )
            inv = inv + self.gps_pe_lift(batch.pe)
        outputs = self._decode(self.decoder_0, read0, batch)
        for i in range(cfg.num_conv_layers):
            h, equiv = self.stack.conv(i, inv, equiv, batch, extras)
            inv = getattr(self, f"gps_{i}")(inv, h, batch) if cfg.use_global_attn else h
            inv = self._condition_inv(inv, batch)
            out_i = self._decode(getattr(self, f"decoder_{i + 1}"), inv, batch)
            outputs = [a + b for a, b in zip(outputs, out_i)]
        return outputs

    def forward(self, batch) -> List[torch.Tensor]:
        if self.per_layer_readouts:
            return self._forward_per_layer_readouts(batch)
        node_repr, _ = self.encode(batch)
        return self._decode(self.decoder, node_repr, batch)
