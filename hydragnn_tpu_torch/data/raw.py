"""Raw-format reader and the raw -> GraphSample processing pipeline.

Counterpart of ``hydragnn_tpu/data/raw.py``: ``RawSample``,
``read_lsms_directory``, ``minmax_normalize`` and
``process_raw_samples``, copied so that the samples equal the JAX
package's array for array. A GPS config (``global_attn_engine`` with
``pe_dim > 0``) attaches each sample's Laplacian PE and relative PE.
With ``periodic_boundary_conditions``, a sample that carries a cell gets
the periodic radius graph and its image shifts (the chain edges that
``ensure_connected`` adds take zero shifts); one without a cell gets the
plain radius graph, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample
from hydragnn_tpu_torch.ops.neighbors import (
    ensure_connected,
    radius_graph,
    radius_graph_pbc,
)
from hydragnn_tpu_torch.ops.pe import laplacian_pe, relative_pe


@dataclasses.dataclass
class RawSample:
    """One raw configuration: full node table + graph-level features."""

    node_features: np.ndarray  # [n, n_node_feats] selected feature columns
    positions: np.ndarray  # [n, 3]
    graph_features: np.ndarray  # [n_graph_feats]
    cell: Optional[np.ndarray] = None  # [3, 3]
    dataset_id: int = 0


def read_lsms_directory(path: str, config_dataset: dict) -> List[RawSample]:
    """Read every LSMS text file in ``path`` (sorted by name): line 0 =
    graph outputs, following lines = per-node rows ``feature index x y z
    out1 out2 ...``. ``Dataset.node_features.column_index`` /
    ``Dataset.graph_features.column_index`` select the feature columns."""
    node_cols = config_dataset["node_features"]["column_index"]
    graph_cols = config_dataset["graph_features"]["column_index"]
    samples = []
    for fname in sorted(glob.glob(os.path.join(path, "*.txt"))):
        with open(fname) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        graph_vals = np.array([float(v) for v in lines[0].split()])
        table = np.array([[float(v) for v in ln.split()] for ln in lines[1:]])
        samples.append(
            RawSample(
                node_features=table[:, node_cols],
                positions=table[:, 2:5],
                graph_features=graph_vals[graph_cols],
            )
        )
    return samples


def minmax_normalize(samples: Sequence[RawSample]) -> List[RawSample]:
    """Scale node/graph features to [0, 1] with dataset-wide min/max."""
    if not samples:
        raise ValueError(
            "No raw samples to normalize — is the dataset directory empty?"
        )
    node_all = np.concatenate([s.node_features for s in samples], axis=0)
    node_min = node_all.min(axis=0)
    node_max = node_all.max(axis=0)
    node_rng = np.where(node_max > node_min, node_max - node_min, 1.0)
    graph_all = np.stack([s.graph_features for s in samples], axis=0)
    g_min = graph_all.min(axis=0)
    g_max = graph_all.max(axis=0)
    g_rng = np.where(g_max > g_min, g_max - g_min, 1.0)
    return [
        dataclasses.replace(
            s,
            node_features=(s.node_features - node_min) / node_rng,
            graph_features=(s.graph_features - g_min) / g_rng,
        )
        for s in samples
    ]


def process_raw_samples(
    raw: Sequence[RawSample], config: dict, *, normalize: bool = True
) -> List[GraphSample]:
    """Raw tables -> GraphSamples per the config's variables of interest:
    radius graph (periodic where the config and the sample's cell say
    so; with connectivity repair), input columns, graph and node
    targets."""
    nn_cfg = config["NeuralNetwork"]
    arch = nn_cfg["Architecture"]
    if normalize:
        raw = minmax_normalize(raw)
    voi = nn_cfg["Variables_of_interest"]
    radius = float(arch.get("radius") or 5.0)
    max_neigh = arch.get("max_neighbours")
    pbc = bool(arch.get("periodic_boundary_conditions", False))
    pe_dim = int(arch.get("pe_dim") or 0) if arch.get("global_attn_engine") else 0
    input_cols = voi.get("input_node_features", [0])
    out_types = voi.get("type", [])
    out_index = voi.get("output_index", [])

    samples = []
    for s in raw:
        shifts = None
        if pbc and s.cell is not None:
            edge_index, shifts = radius_graph_pbc(
                s.positions, s.cell, radius, max_neighbours=max_neigh
            )
        else:
            edge_index = radius_graph(s.positions, radius, max_neighbours=max_neigh)
        edge_index = ensure_connected(edge_index, s.node_features.shape[0])
        if shifts is not None and edge_index.shape[1] != shifts.shape[0]:
            extra = edge_index.shape[1] - shifts.shape[0]
            shifts = np.concatenate([shifts, np.zeros((extra, 3))], axis=0)
        y_graph_cols = [
            s.graph_features[out_index[i]]
            for i, t in enumerate(out_types)
            if t == "graph"
        ]
        y_node_cols = [
            s.node_features[:, out_index[i] : out_index[i] + 1]
            for i, t in enumerate(out_types)
            if t == "node"
        ]
        pe = rel = None
        if pe_dim > 0:
            pe = laplacian_pe(edge_index, s.node_features.shape[0], pe_dim)
            rel = relative_pe(edge_index, pe)
        samples.append(
            GraphSample(
                x=s.node_features[:, input_cols].astype(np.float32),
                pos=s.positions.astype(np.float32),
                edge_index=edge_index.astype(np.int64),
                edge_shifts=None if shifts is None else shifts.astype(np.float32),
                y_graph=(
                    np.array(y_graph_cols, dtype=np.float32) if y_graph_cols else None
                ),
                y_node=(
                    np.concatenate(y_node_cols, axis=1).astype(np.float32)
                    if y_node_cols
                    else None
                ),
                dataset_id=s.dataset_id,
                cell=s.cell,
                pe=pe,
                rel_pe=rel,
            )
        )
    return samples
