"""Static model specification.

Counterpart of ``hydragnn_tpu/models/spec.py`` (``BranchSpec``,
``HeadSpec``, ``ModelConfig``, ``model_config_from_dict``), copied: the
module is plain Python, but the port may not import the JAX package.
``model_config_from_dict`` reads a full (post-``update_config``) JSON
config; ``update_config`` itself is ported with the config module
(ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BranchSpec:
    """One decoder branch (multibranch GFM training shares the encoder and
    routes each sample to its dataset's branch decoder)."""

    name: str = "branch-0"
    num_sharedlayers: int = 1
    dim_sharedlayers: int = 16
    num_headlayers: int = 1
    dim_headlayers: Tuple[int, ...] = (16,)
    node_head_type: str = "mlp"  # mlp | mlp_per_node | conv


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """One output variable (one loss task)."""

    name: str
    type: str  # "graph" | "node"
    dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    mpnn_type: str = "SchNet"
    input_dim: int = 1
    hidden_dim: int = 64
    num_conv_layers: int = 3
    heads: Tuple[HeadSpec, ...] = ()
    graph_branches: Tuple[BranchSpec, ...] = ()
    node_branches: Tuple[BranchSpec, ...] = ()
    task_weights: Tuple[float, ...] = ()
    activation: str = "relu"
    loss_function_type: str = "mse"
    graph_pooling: str = "mean"  # mean | add | max
    dropout: float = 0.25

    # Geometry / radial
    radius: Optional[float] = None
    max_neighbours: Optional[int] = None
    num_gaussians: Optional[int] = None
    num_filters: Optional[int] = None
    num_radial: Optional[int] = None
    num_spherical: Optional[int] = None
    envelope_exponent: Optional[int] = None
    radial_type: Optional[str] = None
    distance_transform: Optional[str] = None
    basis_emb_size: Optional[int] = None
    int_emb_size: Optional[int] = None
    out_emb_size: Optional[int] = None
    num_before_skip: Optional[int] = None
    num_after_skip: Optional[int] = None

    # Edge features
    edge_dim: Optional[int] = None

    # Equivariance (EGNN/SchNet coordinate updates; reference
    # config_utils.py update_config_equivariance)
    equivariance: bool = False

    # PNA
    pna_deg: Optional[Tuple[int, ...]] = None

    # MACE
    avg_num_neighbors: Optional[float] = None
    correlation: Optional[int] = None
    max_ell: Optional[int] = None
    node_max_ell: Optional[int] = None

    # GPS global attention
    global_attn_engine: Optional[str] = None
    global_attn_type: Optional[str] = None
    global_attn_heads: int = 0
    pe_dim: int = 0

    # Conditioning on graph-level attributes (FiLM / concat / fuse_pool;
    # reference Base.py:299-444)
    use_graph_attr_conditioning: bool = False
    graph_attr_conditioning_mode: str = "concat_node"
    graph_attr_dim: int = 0

    # Loss variance channel (GaussianNLL; reference Base.py:108-112)
    var_output: int = 0

    # Periodic boundary conditions
    periodic_boundary_conditions: bool = False

    # Interatomic potential (MLIP) training: forces = -dE/dpos
    # (reference EnhancedModelWrapper, hydragnn/models/create.py:594-596)
    enable_interatomic_potential: bool = False
    energy_weight: float = 0.0
    energy_peratom_weight: float = 0.0
    force_weight: float = 0.0

    # Fixed node count (for mlp_per_node heads)
    num_nodes: Optional[int] = None

    # Norm/precision
    conv_checkpointing: bool = False

    # ------------------------------------------------------------------
    @property
    def num_heads(self) -> int:
        return len(self.heads)

    @property
    def use_global_attn(self) -> bool:
        return bool(self.global_attn_engine)

    @property
    def graph_head_dim(self) -> int:
        return sum(h.dim for h in self.heads if h.type == "graph")

    @property
    def node_head_dim(self) -> int:
        return sum(h.dim for h in self.heads if h.type == "node")

    def head_offsets(self) -> Tuple[Tuple[str, int, int], ...]:
        """Per head: (level, start, end) column range into y_graph/y_node."""
        offs = []
        g_off = n_off = 0
        for h in self.heads:
            if h.type == "graph":
                offs.append(("graph", g_off, g_off + h.dim))
                g_off += h.dim
            else:
                offs.append(("node", n_off, n_off + h.dim))
                n_off += h.dim
        return tuple(offs)

    @property
    def num_branches(self) -> int:
        return max(len(self.graph_branches), len(self.node_branches), 1)


def model_config_from_dict(config: dict) -> ModelConfig:
    """Build a ModelConfig from a full (post-``update_config``) JSON config."""
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"].get("Training", {})
    voi = config["NeuralNetwork"].get("Variables_of_interest", {})

    out_names = voi.get("output_names") or [
        f"task{i}" for i in range(len(arch.get("output_type", [])))
    ]
    heads = tuple(
        HeadSpec(name=str(n), type=str(t), dim=int(d))
        for n, t, d in zip(out_names, arch["output_type"], arch["output_dim"])
    )

    weights = arch.get("task_weights") or [1.0] * len(heads)
    wsum = sum(abs(w) for w in weights)
    task_weights = tuple(float(w) / wsum for w in weights)

    output_heads = arch.get("output_heads", {})
    graph_branches = tuple(
        BranchSpec(
            name=str(b["type"]),
            num_sharedlayers=int(b["architecture"].get("num_sharedlayers", 1)),
            dim_sharedlayers=int(b["architecture"].get("dim_sharedlayers", 16)),
            num_headlayers=int(b["architecture"].get("num_headlayers", 1)),
            dim_headlayers=tuple(
                int(x) for x in b["architecture"].get("dim_headlayers", [16])
            ),
        )
        for b in output_heads.get("graph", [])
    )
    node_branches = tuple(
        BranchSpec(
            name=str(b["type"]),
            num_headlayers=int(b["architecture"].get("num_headlayers", 1)),
            dim_headlayers=tuple(
                int(x) for x in b["architecture"].get("dim_headlayers", [16])
            ),
            node_head_type=str(b["architecture"].get("type", "mlp")),
        )
        for b in output_heads.get("node", [])
    )

    loss_type = training.get("loss_function_type", "mse")
    pooling = str(arch.get("graph_pooling", "mean")).lower()
    if pooling == "sum":
        pooling = "add"

    pna_deg = arch.get("pna_deg")
    return ModelConfig(
        mpnn_type=arch["mpnn_type"],
        input_dim=int(arch.get("input_dim", 1)),
        hidden_dim=int(arch.get("hidden_dim", 64)),
        num_conv_layers=int(arch.get("num_conv_layers", 3)),
        heads=heads,
        graph_branches=graph_branches,
        node_branches=node_branches,
        task_weights=task_weights,
        activation=str(arch.get("activation_function", "relu")),
        loss_function_type=str(loss_type),
        graph_pooling=pooling,
        dropout=float(arch.get("dropout", 0.25)),
        radius=_opt_float(arch.get("radius")),
        max_neighbours=_opt_int(arch.get("max_neighbours")),
        num_gaussians=_opt_int(arch.get("num_gaussians")),
        num_filters=_opt_int(arch.get("num_filters")),
        num_radial=_opt_int(arch.get("num_radial")),
        num_spherical=_opt_int(arch.get("num_spherical")),
        envelope_exponent=_opt_int(arch.get("envelope_exponent")),
        radial_type=arch.get("radial_type"),
        distance_transform=arch.get("distance_transform"),
        basis_emb_size=_opt_int(arch.get("basis_emb_size")),
        int_emb_size=_opt_int(arch.get("int_emb_size")),
        out_emb_size=_opt_int(arch.get("out_emb_size")),
        num_before_skip=_opt_int(arch.get("num_before_skip")),
        num_after_skip=_opt_int(arch.get("num_after_skip")),
        edge_dim=_opt_int(arch.get("edge_dim")),
        equivariance=bool(arch.get("equivariance") or False),
        pna_deg=None if pna_deg is None else tuple(int(x) for x in pna_deg),
        avg_num_neighbors=_opt_float(arch.get("avg_num_neighbors")),
        correlation=_opt_int(arch.get("correlation")),
        max_ell=_opt_int(arch.get("max_ell")),
        node_max_ell=_opt_int(arch.get("node_max_ell")),
        global_attn_engine=arch.get("global_attn_engine") or None,
        global_attn_type=arch.get("global_attn_type") or None,
        global_attn_heads=int(arch.get("global_attn_heads") or 0),
        pe_dim=int(arch.get("pe_dim") or 0),
        use_graph_attr_conditioning=bool(
            arch.get("use_graph_attr_conditioning", False)
        ),
        graph_attr_conditioning_mode=str(
            arch.get("graph_attr_conditioning_mode", "concat_node")
        ).lower(),
        graph_attr_dim=int(arch.get("graph_attr_dim", 0)),
        var_output=1 if loss_type == "GaussianNLLLoss" else 0,
        periodic_boundary_conditions=bool(
            arch.get("periodic_boundary_conditions", False)
        ),
        enable_interatomic_potential=bool(
            arch.get("enable_interatomic_potential", False)
        ),
        energy_weight=float(arch.get("energy_weight", 0.0)),
        energy_peratom_weight=float(arch.get("energy_peratom_weight", 0.0)),
        force_weight=float(arch.get("force_weight", 0.0)),
        num_nodes=_opt_int(arch.get("num_nodes")),
        conv_checkpointing=bool(training.get("conv_checkpointing", False)),
    )


def _opt_int(v) -> Optional[int]:
    return None if v is None else int(v)


def _opt_float(v) -> Optional[float]:
    return None if v is None else float(v)
