"""Static-shape graph batches for the port.

Counterpart of ``hydragnn_tpu/data/graph.py``: ``GraphSample`` (one host
graph), ``GraphBatch`` (a padded batch with the same fields, as tensors),
the dataset-wide optional-field map (``optional_field_widths``,
``optional_field_widths_multi``), ``select_input_features``,
``bucket_size``, ``build_triplets``,
``count_triplets``, ``fill_triplets``, ``PackSpec``, ``PadSpec``,
``collate`` and ``apply_segment_plan``. The host work is the JAX package's numpy code,
copied, so collated arrays match it bit for bit.

Conventions (as in the JAX package): nodes of all graphs are
concatenated and padded to ``num_nodes``; padding nodes/edges belong to
a trailing padding graph and are masked; edges are directed
``senders[k] -> receivers[k]`` and aggregate at ``receivers``.

One addition: a planned batch records the tile sizes its block plan was
built with (``seg_tile = (be, bn)``), because the port's planner takes
them as parameters where the JAX package fixed them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hydragnn_tpu_torch.ops.edge_pipeline import (
    DEFAULT_BE,
    DEFAULT_BN,
    plan_blocks_static,
    static_block_bound,
)

Array = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class GraphBatch:
    """A padded batch of graphs with static shapes.

    N = padded node count, E = padded edge count, G = padded graph count
    (including at least one padding graph slot). Fields are numpy arrays
    straight out of ``collate(as_numpy=True)``, tensors otherwise.
    """

    # Node-level
    x: Array  # [N, F] node input features
    pos: Optional[Array]  # [N, 3] positions
    node_graph_idx: Array  # [N] int32 graph id of each node (non-decreasing)
    node_slot: Array  # [N] int32 index of node within its graph
    node_mask: Array  # [N] bool

    # Edge-level
    senders: Array  # [E] int32
    receivers: Array  # [E] int32
    edge_mask: Array  # [E] bool

    # Graph-level
    graph_mask: Array  # [G] bool

    # Optional payloads
    edge_attr: Optional[Array] = None  # [E, Fe]
    edge_shifts: Optional[Array] = None  # [E, 3]
    y_graph: Optional[Array] = None  # [G, Dg]
    y_node: Optional[Array] = None  # [N, Dn]
    graph_attr: Optional[Array] = None  # [G, Da]
    dataset_id: Optional[Array] = None  # [G] int32
    pe: Optional[Array] = None  # [N, pe_dim]
    rel_pe: Optional[Array] = None  # [E, pe_dim]
    cell: Optional[Array] = None  # [G, 3, 3]
    energy_weight: Optional[Array] = None  # [G]
    energy: Optional[Array] = None  # [G]
    forces: Optional[Array] = None  # [N, 3]

    # Angular triplets (DimeNet): triplet t feeds edge t_kj[t] = k->j into
    # edge t_ji[t] = j->i (k != i); padding triplets index the last edge
    # slot and are masked.
    t_kj: Optional[Array] = None  # [T] int32
    t_ji: Optional[Array] = None  # [T] int32
    triplet_mask: Optional[Array] = None  # [T] bool

    # Sorted-segment block plan for receiver aggregation
    # (ops/edge_pipeline.py); edges are sorted by receiver when present.
    seg_perm: Optional[Array] = None  # [B*be] int32
    seg_ids: Optional[Array] = None  # [B*be] int32
    seg_valid: Optional[Array] = None  # [B*be] bool
    seg_window: Optional[Array] = None  # [B] int32
    seg_tile: Optional[Tuple[int, int]] = None  # (be, bn) of the plan

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    @property
    def num_graphs(self) -> int:
        return int(self.graph_mask.shape[0])

    def arrays(self) -> Dict[str, Array]:
        """Every array field that is present, by name."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "seg_tile" and getattr(self, f.name) is not None
        }

    def to(
        self, device: Union[str, torch.device], non_blocking: bool = False
    ) -> "GraphBatch":
        """A copy with every array field as a tensor on ``device``."""
        moved = {
            k: torch.as_tensor(v).to(device, non_blocking=non_blocking)
            for k, v in self.arrays().items()
        }
        return dataclasses.replace(self, **moved)


@dataclasses.dataclass
class GraphSample:
    """One graph on the host (numpy), before collation."""

    x: np.ndarray  # [n, F]
    pos: Optional[np.ndarray] = None  # [n, 3]
    edge_index: Optional[np.ndarray] = None  # [2, e] (senders, receivers)
    edge_attr: Optional[np.ndarray] = None  # [e, Fe]
    edge_shifts: Optional[np.ndarray] = None  # [e, 3]
    y_graph: Optional[np.ndarray] = None  # [Dg]
    y_node: Optional[np.ndarray] = None  # [n, Dn]
    graph_attr: Optional[np.ndarray] = None  # [Da]
    dataset_id: int = 0
    pe: Optional[np.ndarray] = None  # [n, pe_dim]
    rel_pe: Optional[np.ndarray] = None  # [e, pe_dim]
    cell: Optional[np.ndarray] = None  # [3, 3]
    energy: Optional[float] = None
    forces: Optional[np.ndarray] = None  # [n, 3]

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return 0 if self.edge_index is None else int(self.edge_index.shape[1])


# Input-side optional fields: zero-filling an absent one means "no
# feature" (open boundary, no conditioning attribute, no PE), so a mixed
# dataset may materialize them in every batch.
_ZERO_FILL_FIELDS = ("edge_attr", "edge_shifts", "rel_pe", "pe", "graph_attr")
# Fields where a zero fill would train toward zero labels or positions:
# present on every sample of a dataset or on none.
_ALL_OR_NONE_FIELDS = ("pos", "energy", "forces", "y_graph", "y_node")


def optional_field_widths(dataset) -> dict:
    """{optional field -> last-dim width} over a whole dataset: the
    ``ensure_fields`` map for ``collate``, so every batch of a mixed
    dataset carries the same optional fields (``cell`` maps to None:
    collate tests the key only). Raises on inconsistent widths and on
    a label or position field present on some samples only.

    A container that knows the map from its own metadata (``BinDataset``'s
    header, a pickle directory's meta) answers through ``field_widths()``
    with no sample read; otherwise one scan, cached on the dataset object
    so several loaders over one lazy dataset read it once."""
    fw = getattr(dataset, "field_widths", None)
    if callable(fw):
        meta = fw()
        if meta is not None:
            return dict(meta)
    cached = getattr(dataset, "_cached_field_widths", None)
    if cached is not None:
        return dict(cached)
    widths: dict = {}
    present = {f: 0 for f in _ALL_OR_NONE_FIELDS}
    has_cell = False
    n = 0
    for s in dataset:
        n += 1
        for f in _ZERO_FILL_FIELDS + _ALL_OR_NONE_FIELDS:
            v = getattr(s, f)
            if v is None:
                continue
            if f in _ALL_OR_NONE_FIELDS:
                present[f] += 1
            if f == "energy":
                continue  # a scalar: no width
            w = int(np.atleast_2d(v).shape[-1])
            if widths.setdefault(f, w) != w:
                raise ValueError(
                    f"Inconsistent {f} widths across the dataset: "
                    f"{widths[f]} vs {w} — homogeneous batches would "
                    "collate to divergent shapes"
                )
        if s.cell is not None:
            has_cell = True
    for f, c in present.items():
        if 0 < c < n:
            raise ValueError(
                f"Partially-labeled dataset: {f} present on {c}/{n} "
                "samples; label and position fields must be present on "
                "all samples or none"
            )
    out = {f: widths[f] for f in _ZERO_FILL_FIELDS if f in widths}
    if has_cell:
        out["cell"] = None
    try:
        dataset._cached_field_widths = dict(out)
    except (AttributeError, TypeError):
        pass  # plain lists and tuples cannot carry the cache
    return out


def optional_field_widths_multi(datasets) -> dict:
    """One ``ensure_fields`` map over several datasets (the train, val and
    test splits), each through its own metadata or cached scan and then
    merged, so lazy containers are never concatenated into one list.
    Raises on widths that conflict across datasets and on label or
    position fields present in some splits only (presence is uniform
    within a dataset, so one sample, or the container's
    ``label_fields()``, tells a split's)."""
    datasets = [d for d in datasets if len(d)]
    out: dict = {}
    for d in datasets:
        for k, w in optional_field_widths(d).items():
            if k in out and out[k] != w:
                raise ValueError(
                    f"Inconsistent {k} widths across datasets: "
                    f"{out[k]} vs {w} — homogeneous batches would "
                    "collate to divergent shapes"
                )
            out.setdefault(k, w)

    def _presence(d):
        lf = getattr(d, "label_fields", None)
        if callable(lf):
            return lf()
        return frozenset(f for f in _ALL_OR_NONE_FIELDS if getattr(d[0], f) is not None)

    presence = [_presence(d) for d in datasets]
    if presence and any(p != presence[0] for p in presence[1:]):
        raise ValueError(
            "Partially-labeled dataset: label/position fields differ "
            f"across datasets ({[sorted(p) for p in presence]}); "
            "fields must be present on all splits or none"
        )
    return out


def select_input_features(samples, input_cols):
    """Column-select every sample's node features
    (``Variables_of_interest.input_node_features``). Returns ``samples``
    unchanged (the same object) when the selection already covers the
    first sample's columns in order, as raw-ingested samples do;
    otherwise a new list of selected samples."""
    if input_cols is None or len(samples) == 0:
        return samples
    cols = [int(c) for c in input_cols]
    if not cols:
        return samples
    if min(cols) < 0:
        raise ValueError(
            f"input_node_features {cols} must be non-negative column indices"
        )
    if cols == list(range(int(samples[0].x.shape[1]))):
        return samples
    out = []
    for s in samples:
        width = int(s.x.shape[1])
        if max(cols) >= width:
            raise ValueError(
                f"input_node_features {cols} out of range for node features "
                f"of width {width}"
            )
        out.append(dataclasses.replace(s, x=np.ascontiguousarray(s.x[:, cols])))
    return out


def bucket_size(n: int, *, base: int = 8, growth: float = 1.25) -> int:
    """Smallest ladder value >= n; ladder = base * growth^k, rounded to 8."""
    if n <= base:
        return base
    size = float(base)
    while size < n:
        size *= growth
    return int(int(np.ceil(size / 8.0)) * 8)


def build_triplets(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int
) -> tuple[np.ndarray, np.ndarray]:
    """The angular triplets of a graph: every pair of edges (k->j, j->i)
    with k != i, as (t_kj, t_ji) edge indices, in order of t_ji."""
    E = int(len(senders))
    if E == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    order = np.argsort(receivers, kind="stable")
    counts_in = np.bincount(receivers, minlength=num_nodes)
    ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    ptr[1:] = np.cumsum(counts_in)
    deg = counts_in[senders]  # incoming edges at j for each edge j->i
    total = int(deg.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    t_ji_all = np.repeat(np.arange(E, dtype=np.int64), deg)
    seg_off = np.cumsum(deg) - deg
    local = np.arange(total, dtype=np.int64) - np.repeat(seg_off, deg)
    t_kj_all = order[ptr[senders[t_ji_all]] + local]
    valid = senders[t_kj_all] != receivers[t_ji_all]
    return t_kj_all[valid], t_ji_all[valid]


def count_triplets(sample: "GraphSample") -> int:
    """The number of triplets ``build_triplets`` gives a sample, without
    building them: each edge j->i pairs with indeg(j) edges, less one
    where the reciprocal edge i->j exists (k == i)."""
    if sample.edge_index is None or sample.num_edges == 0:
        return 0
    snd = np.asarray(sample.edge_index[0], dtype=np.int64)
    rcv = np.asarray(sample.edge_index[1], dtype=np.int64)
    n = int(sample.num_nodes)
    indeg = np.bincount(rcv, minlength=n)
    total = int(indeg[snd].sum())
    keys = snd * n + rcv
    reciprocal = int(np.isin(rcv * n + snd, keys).sum())
    return total - reciprocal


def fill_triplets(t_kj, t_ji, triplet_mask, senders, receivers, e_real, n_real):
    """Build a batch's triplets into preallocated ``[T]`` buffers (every
    slot is written). Padding triplets index the last edge slot (a
    self-loop at the padding node) and are masked."""
    T = int(t_kj.shape[0])
    E = int(senders.shape[0])
    kj, ji = build_triplets(senders[:e_real], receivers[:e_real], n_real)
    if len(kj) > T:
        raise ValueError(f"PadSpec too small: {len(kj)} triplets > {T} slots")
    t_kj[...] = E - 1
    t_ji[...] = E - 1
    triplet_mask[...] = False
    t_kj[: len(kj)] = kj
    t_ji[: len(ji)] = ji
    triplet_mask[: len(kj)] = True


def apply_segment_plan(
    senders, receivers, edge_mask, edge_payloads, e_real, N,
    be: int = DEFAULT_BE, bn: int = DEFAULT_BN,
):
    """Sort the real edges by receiver IN PLACE (padding edges already
    target the first padding node, which sorts after every real
    receiver) and build the static-size block plan at tiles (be, bn).
    The edge mask is folded into the plan's valid slots. Returns
    (seg_perm, seg_ids, seg_valid, seg_window)."""
    order = np.argsort(receivers[:e_real], kind="stable")
    for arr in (senders, receivers, edge_mask):
        arr[:e_real] = arr[:e_real][order]
    for arr in edge_payloads.values():
        if arr is not None:
            arr[:e_real] = arr[:e_real][order]
    b_max = static_block_bound(receivers.shape[0], N, be, bn)
    return plan_blocks_static(
        receivers, N, b_max, be, bn, edge_valid=edge_mask
    )


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """A bin-packing budget: one padded batch shape plus the real
    capacities a packed batch may fill. ``num_nodes``/``num_graphs``
    include the mandatory padding slot."""

    num_nodes: int
    num_edges: int
    num_graphs: int

    @property
    def capacity_nodes(self) -> int:
        return self.num_nodes - 1

    @property
    def capacity_edges(self) -> int:
        return self.num_edges

    @property
    def capacity_graphs(self) -> int:
        return self.num_graphs - 1

    def fits(self, n_nodes: int, n_edges: int, n_graphs: int) -> bool:
        return (
            n_nodes <= self.capacity_nodes
            and n_edges <= self.capacity_edges
            and n_graphs <= self.capacity_graphs
        )

    def pad_spec(self) -> "PadSpec":
        return PadSpec(
            num_nodes=self.num_nodes,
            num_edges=self.num_edges,
            num_graphs=self.num_graphs,
            num_triplets=None,
        )


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static padded sizes for one bucket."""

    num_nodes: int
    num_edges: int
    num_graphs: int
    num_triplets: Optional[int] = None  # None = do not build triplets

    @staticmethod
    def for_samples(
        samples: Sequence[GraphSample], *, with_triplets: bool = False
    ) -> "PadSpec":
        """Bucketed sizes for these samples, with the +1 node and graph
        slots (edge padding targets the padding node); ``with_triplets``
        adds the triplet count, bucketed like the edges."""
        t = None
        if with_triplets:
            t = bucket_size(max(sum(count_triplets(s) for s in samples), 1))
        return PadSpec(
            num_nodes=bucket_size(sum(s.num_nodes for s in samples) + 1),
            num_edges=bucket_size(max(sum(s.num_edges for s in samples), 1)),
            num_graphs=len(samples) + 1,
            num_triplets=t,
        )


def collate(
    samples: Sequence[GraphSample],
    pad: Optional[PadSpec] = None,
    *,
    with_segment_plan: bool = False,
    be: int = DEFAULT_BE,
    bn: int = DEFAULT_BN,
    ensure_fields: Optional[dict] = None,
    as_numpy: bool = False,
) -> GraphBatch:
    """Concatenate and pad host graphs into a static-shape GraphBatch.

    Padding nodes/edges are assigned to graph slot ``len(samples)`` and
    node slot ``tot_nodes`` (the first padding node). With
    ``with_segment_plan`` the edges are sorted by receiver and the block
    plan for the fused edge pipeline is attached at tiles ``(be, bn)``.
    A ``pad`` with ``num_triplets`` gets the angular triplets
    (``fill_triplets``) of the edges in their final order.
    ``ensure_fields`` maps optional field names to last-dim widths that
    materialize (zero-filled) even when every sample of the batch lacks
    them, so every batch of a mixed dataset has one structure (``cell``
    is membership-tested only), as in the JAX package.
    Floating fields are float32. ``as_numpy`` keeps host
    arrays; otherwise the fields are CPU tensors (``GraphBatch.to``
    moves them to a device).
    """
    if pad is None:
        pad = PadSpec.for_samples(samples)
    n_real = sum(s.num_nodes for s in samples)
    e_real = sum(s.num_edges for s in samples)
    g_real = len(samples)
    if n_real >= pad.num_nodes:
        raise ValueError(
            f"PadSpec too small: {n_real} real nodes need >= {n_real + 1} "
            f"padded slots, got {pad.num_nodes}"
        )
    if e_real > pad.num_edges or g_real >= pad.num_graphs:
        raise ValueError(
            f"PadSpec too small: edges {e_real}/{pad.num_edges}, "
            f"graphs {g_real}/{pad.num_graphs} (need one padding graph slot)"
        )

    N, E, G = pad.num_nodes, pad.num_edges, pad.num_graphs
    f_dim = samples[0].x.shape[1] if samples[0].x.ndim > 1 else 1

    dtype = np.float32
    x = np.zeros((N, f_dim), dtype=dtype)
    node_graph_idx = np.full((N,), g_real, dtype=np.int32)
    node_slot = np.zeros((N,), dtype=np.int32)
    node_mask = np.zeros((N,), dtype=bool)
    senders = np.full((E,), n_real, dtype=np.int32)
    receivers = np.full((E,), n_real, dtype=np.int32)
    edge_mask = np.zeros((E,), dtype=bool)
    graph_mask = np.zeros((G,), dtype=bool)
    graph_mask[:g_real] = True

    def _opt(field: str, width_of) -> Optional[np.ndarray]:
        vals = [getattr(s, field) for s in samples]
        if all(v is None for v in vals):
            if ensure_fields and field in ensure_fields:
                return np.zeros((width_of, int(ensure_fields[field])), dtype=dtype)
            return None
        dims = {np.atleast_2d(v).shape[-1] for v in vals if v is not None}
        if len(dims) != 1:
            raise ValueError(f"Inconsistent {field} dims across samples: {dims}")
        return np.zeros((width_of, dims.pop()), dtype=dtype)

    pos = _opt("pos", N)
    forces = _opt("forces", N)
    # Every edge-aligned optional array lives here so the plan's sort
    # reorders all of them together with senders/receivers.
    edge_payloads = {
        f: _opt(f, E) for f in ("edge_attr", "edge_shifts", "rel_pe")
    }
    edge_attr = edge_payloads["edge_attr"]
    edge_shifts = edge_payloads["edge_shifts"]
    rel_pe = edge_payloads["rel_pe"]
    y_node = _opt("y_node", N)
    pe = _opt("pe", N)
    y_graph = _opt("y_graph", G)
    graph_attr = _opt("graph_attr", G)
    cell = None
    if any(s.cell is not None for s in samples) or (
        ensure_fields and "cell" in ensure_fields
    ):
        cell = np.tile(np.eye(3, dtype=dtype), (G, 1, 1))
    energy = None
    if any(s.energy is not None for s in samples):
        if not all(s.energy is not None for s in samples):
            raise ValueError(
                "Partially-labeled batch: some samples have energy and "
                "some do not (zero-filled targets would silently train "
                "toward 0)."
            )
        energy = np.zeros((G,), dtype=dtype)
    if any(s.forces is not None for s in samples) and not all(
        s.forces is not None for s in samples
    ):
        raise ValueError(
            "Partially-labeled batch: some samples have forces and some "
            "do not."
        )
    dataset_id = np.zeros((G,), dtype=np.int32)

    node_off = 0
    edge_off = 0
    for gi, s in enumerate(samples):
        n = s.num_nodes
        e = s.num_edges
        x[node_off : node_off + n] = np.atleast_2d(s.x.reshape(n, -1))
        node_graph_idx[node_off : node_off + n] = gi
        node_slot[node_off : node_off + n] = np.arange(n)
        node_mask[node_off : node_off + n] = True
        if pos is not None and s.pos is not None:
            pos[node_off : node_off + n] = s.pos
        if forces is not None and s.forces is not None:
            forces[node_off : node_off + n] = s.forces
        if y_node is not None and s.y_node is not None:
            y_node[node_off : node_off + n] = s.y_node.reshape(n, -1)
        if pe is not None and s.pe is not None:
            pe[node_off : node_off + n] = s.pe.reshape(n, -1)
        if e:
            senders[edge_off : edge_off + e] = s.edge_index[0] + node_off
            receivers[edge_off : edge_off + e] = s.edge_index[1] + node_off
            edge_mask[edge_off : edge_off + e] = True
            if edge_attr is not None and s.edge_attr is not None:
                edge_attr[edge_off : edge_off + e] = s.edge_attr.reshape(e, -1)
            if edge_shifts is not None and s.edge_shifts is not None:
                edge_shifts[edge_off : edge_off + e] = s.edge_shifts
            if rel_pe is not None and s.rel_pe is not None:
                rel_pe[edge_off : edge_off + e] = s.rel_pe.reshape(e, -1)
        if y_graph is not None and s.y_graph is not None:
            y_graph[gi] = np.asarray(s.y_graph).reshape(-1)
        if graph_attr is not None and s.graph_attr is not None:
            graph_attr[gi] = np.asarray(s.graph_attr).reshape(-1)
        if cell is not None and s.cell is not None:
            cell[gi] = s.cell
        if energy is not None and s.energy is not None:
            energy[gi] = float(np.asarray(s.energy).reshape(-1)[0])
        dataset_id[gi] = s.dataset_id
        node_off += n
        edge_off += e

    # Padding nodes: consecutive slot ids within the padding graph.
    node_slot[node_off:] = np.arange(N - node_off)

    seg_perm = seg_ids = seg_valid = seg_window = seg_tile = None
    if with_segment_plan:
        seg_perm, seg_ids, seg_valid, seg_window = apply_segment_plan(
            senders, receivers, edge_mask, edge_payloads, e_real, N, be, bn
        )
        seg_tile = (int(be), int(bn))

    # Triplets index the edges as they lie after the plan's sort.
    t_kj = t_ji = triplet_mask = None
    if pad.num_triplets is not None:
        T = pad.num_triplets
        t_kj = np.empty((T,), dtype=np.int32)
        t_ji = np.empty((T,), dtype=np.int32)
        triplet_mask = np.empty((T,), dtype=bool)
        fill_triplets(t_kj, t_ji, triplet_mask, senders, receivers, e_real, n_real)

    batch = GraphBatch(
        x=x,
        pos=pos,
        node_graph_idx=node_graph_idx,
        node_slot=node_slot,
        node_mask=node_mask,
        senders=senders,
        receivers=receivers,
        edge_mask=edge_mask,
        graph_mask=graph_mask,
        edge_attr=edge_attr,
        edge_shifts=edge_shifts,
        y_graph=y_graph,
        y_node=y_node,
        graph_attr=graph_attr,
        dataset_id=dataset_id,
        pe=pe,
        rel_pe=rel_pe,
        cell=cell,
        energy=energy,
        forces=forces,
        t_kj=t_kj,
        t_ji=t_ji,
        triplet_mask=triplet_mask,
        seg_perm=seg_perm,
        seg_ids=seg_ids,
        seg_valid=seg_valid,
        seg_window=seg_window,
        seg_tile=seg_tile,
    )
    if as_numpy:
        return batch
    return batch.to("cpu")
