"""Analytic model-FLOPs inventories and the card's peak tables.

Counterpart of ``hydragnn_tpu/utils/flops.py``: the analytic inventories
(``schnet_flops``, ``painn_flops``, ``mace_flops``, ``pnaplus_flops``
and the ``model_flops_per_graph`` dispatch) are copied with the same
arithmetic in the same order, so the live ``mfu`` of the port's
telemetry and the JAX package's are the same function of the same
inputs. Each is a dense multiply-add inventory (x2 = FLOPs) over the
mean REAL node/edge sizes of a graph: no padding, no scatter lowering.

Peaks are keyed by ``torch.cuda.get_device_name()``. The H100 entry is
the dense bf16 tensor-core rate of NVIDIA's data sheet (SXM part, 700 W),
as the JAX package's table holds bf16 peaks: an f32 run's ``mfu`` is
taken against the bf16 peak too. A device the tables do not know (the
CPU included) resolves to ``(None, None)`` and callers omit the metric.
The JAX package's fallback to a TPU roofline anchor (``roofline_anchor``,
which reads ROOFLINE_TPU.txt) has no counterpart here: a TPU table never
stands in for the card. The XLA cost parsers are replaced by the
counted ``executable`` rows of ``utils/telemetry.ExecCounter``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

# Peak dense bf16 FLOP/s by ``torch.cuda.get_device_name()``.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

# Peak HBM bandwidth (bytes/s) by device name.
PEAK_HBM_BYTES_PER_SEC = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def resolve_peak_flops(
    device_kind: Optional[str] = None,
) -> Tuple[Optional[float], Optional[str]]:
    """(peak bf16 FLOP/s, ``"device"``) when the running card is in the
    table, else (None, None)."""
    if device_kind is not None and device_kind in PEAK_FLOPS:
        return PEAK_FLOPS[device_kind], "device"
    return None, None


def resolve_peak_bandwidth(
    device_kind: Optional[str] = None,
) -> Tuple[Optional[float], Optional[str]]:
    """(peak HBM bytes/s, ``"device"``) when the running card is in the
    table, else (None, None): callers omit the ceiling."""
    if device_kind is not None and device_kind in PEAK_HBM_BYTES_PER_SEC:
        return PEAK_HBM_BYTES_PER_SEC[device_kind], "device"
    return None, None


# ----------------------------------------------------------------------
# Per-architecture inventories (the JAX package's, verbatim in their
# arithmetic). All take mean REAL sizes n (nodes/graph) and e
# (edges/graph).
# ----------------------------------------------------------------------


def schnet_flops(n, e, F, G, L, H):
    """SchNet forward multiply-adds (x2 = FLOPs) for n nodes / e edges:
    per conv layer the filter MLP on rbf (G->F->F per edge), cfconv
    in/out projections (F*F per node, twice), message multiply and
    segment add (F per edge each); then shared/head MLPs and the node
    embed. x3 for forward+backward of a train step."""
    fwd = L * (2 * e * (G * F + F * F) + 2 * n * (2 * F * F) + 2 * e * F)
    fwd += 2 * n * H * H + 6 * H * H
    return 3.0 * fwd


def painn_flops(n, e, F, R, L, mlip_factor=9.0):
    """PaiNN training FLOPs per graph. Per layer (multiply-adds x2):
    message scalar MLP per node (F->F->3F), per-edge filter projection
    (R->3F) and gated scalar+vector message (~9F/edge), update-block U/V
    vector projections (2 x 3 x F^2 per node) and update MLP
    (2F->F->3F). The MLIP factor 9 (energy and forces, then the
    parameter gradient) is an upper bound."""
    per_layer = (
        2 * n * (F * F + 3 * F * F)  # message scalar MLP
        + 2 * e * (R * 3 * F)  # filter projection
        + 2 * e * 9 * F  # gated message, 1 scalar + 3 vector comps
        + 2 * n * (2 * 3 * F * F)  # update U/V on vector channels
        + 2 * n * (2 * F * F + 3 * F * F)  # update MLP
    )
    fwd = L * per_layer + 2 * n * F
    return mlip_factor * fwd


def mace_flops(n, e, C, R, lmax, lhid, n_layers):
    """MACE training FLOPs per graph: per layer the irreps linears (C^2
    per l-block), the radial MLP (R+2C -> rd x3 -> P*C per edge), the
    channelwise TP path contractions (C x (2l1+1)(2l2+1)(2l3+1) per edge
    per path), the message scatter, and the symmetric contraction
    (~C x M_e^2 x M_hid per node at correlation 2). x3 for
    forward+backward."""
    from hydragnn_tpu_torch.models.mace import tp_paths

    rd = float(max(1, math.ceil(C / 3.0)))
    M = lambda l: float((l + 1) ** 2)  # noqa: E731

    def layer(l_in, l_h):
        paths = tp_paths(l_in, lmax, lmax)
        P = float(len(paths))
        tp = 2 * e * C * sum(
            (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
            for l1, l2, l3 in paths
        )
        radial = 2 * e * ((R + 2 * C) * rd + 2 * rd * rd + rd * P * C)
        # skip, up, down, post-msg, product, sizing irreps linears
        linears = 2 * n * C * C * (
            M(min(l_in, l_h)) + M(l_in) + 1 + M(lmax) + 2 * M(l_h)
        )
        scatter = 2 * e * C * M(lmax)
        sym = 2 * n * C * M(lmax) ** 2 * M(l_h)
        return tp + radial + linears + scatter + sym

    fwd = 2 * n * C  # element embedding
    for i in range(int(n_layers)):
        l_in = 0 if i == 0 else lhid
        l_h = 0 if i == int(n_layers) - 1 else lhid
        fwd += layer(l_in, l_h)
    return 3.0 * fwd


def pnaplus_flops(n, e, F, R, L, N=0.0):
    """PNAPlus(+GPS) training FLOPs per graph: per layer the PNA edge
    pipeline (rbf embed + pre_nn over 3F concat + rbf hadamard + 12
    aggregate/scale combos) and node post MLPs (13F->F, F->F), plus,
    when ``N`` (the static per-graph node bound) is nonzero, GPS global
    attention (qkv+out projections and dense masked scores over N). x3
    for forward+backward."""
    pna = (
        2 * e * (R * F + 3 * F * F + R * F)  # rbf_emb, pre_nn, rbf_lin
        + 24 * e * F  # 4 aggregators x 3 scalers
        + 2 * n * (13 * F * F + F * F)  # post_nn on [x, scaled], lin
    )
    attn = (
        2 * n * (4 * F * F) + 2 * (2 * N * N * F) if N else 0.0
    )  # qkv/out + scores
    fwd = L * (pna + attn) + 2 * n * F * F + 6 * F * F
    return 3.0 * fwd


def model_flops_per_graph(cfg, mean_n: float, mean_e: float):
    """``cfg`` (models/spec.ModelConfig) dispatched to its analytic
    inventory at mean real sizes ``(mean_n, mean_e)``; None for
    architectures without one (no MFU is emitted). MLIP training
    (``cfg.enable_interatomic_potential``) applies the 9x
    double-backward factor in place of the plain 3x fwd+bwd."""
    n, e = float(mean_n), float(mean_e)
    t = (cfg.mpnn_type or "").lower()
    mlip = 3.0 if cfg.enable_interatomic_potential else 1.0
    F = float(cfg.hidden_dim)
    L = float(cfg.num_conv_layers)
    if t == "schnet":
        return mlip * schnet_flops(
            n,
            e,
            float(cfg.num_filters or cfg.hidden_dim),
            float(cfg.num_gaussians or 50),
            L,
            F,
        )
    if t == "painn":
        R = float(cfg.num_radial or cfg.num_gaussians or 20)
        return painn_flops(n, e, F, R, L, mlip_factor=3.0 * mlip)
    if t == "mace":
        return mlip * mace_flops(
            n,
            e,
            F,
            float(cfg.num_radial or 8),
            int(cfg.max_ell or 1),
            int(cfg.node_max_ell or 1),
            int(cfg.num_conv_layers),
        )
    if t == "pnaplus":
        R = float(cfg.num_radial or 5)
        N = float(cfg.num_nodes or 0) if cfg.use_global_attn else 0.0
        return mlip * pnaplus_flops(n, e, F, R, L, N)
    return None
