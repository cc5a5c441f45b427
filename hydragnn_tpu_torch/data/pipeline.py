"""The parallel input feed: collation workers, packed assembly, feed stats.

Counterpart of ``hydragnn_tpu/data/pipeline.py``. A loader's epoch plan
(``GraphLoader.epoch_plan``: ``(idx, spec)`` per batch from size
metadata alone) is farmed out to a pool of collation threads, and a
sequence-numbered reorder buffer delivers the batches strictly in plan
order, so a seeded epoch gives the serial feed's batches bit for bit.

- **Packed assembly**: ``collate_packed`` builds every field of a batch
  with one ``np.concatenate``/``np.repeat`` per field into reusable
  per-spec buffers; ``PackedStore`` goes further and gathers a batch
  from dataset-wide column tables (a few numpy calls per batch whatever
  its size). Both give ``graph.collate``'s arrays bit for bit, the
  block plan at the Hopper tiles and the triplets included.
- **Workers**: ``ParallelPipelineLoader`` runs ``workers`` threads, at
  most ``min(workers, depth)`` collating at once, ``chunk`` batches per
  task; a superstep group (``superstep_k``) is one task and one
  ``MacroBatch`` delivery of its K batches side by side (the port does
  not stack them into ``[K, ...]``: the step cache packs them into one
  pinned buffer, ``train/capture.py``). A worker's exception is raised
  on the consumer in order; the threads exit when the consumer stops.
- **No device work off the loop thread**: workers hand over host batches
  (CPU tensors, as ``graph.collate`` gives them) and make no CUDA call,
  pinned allocations included. The loop thread's ``StaticBatches.load``
  (a replay) or ``GraphBatch.to`` (a shape's first, eager step) is the
  one host-to-device copy, so a worker can never land a call inside a
  capture the loop thread records under ``capture_error_mode "global"``.
  The loop adds that copy's host time to the stats (``record_h2d``).
- **Stats**: ``PipelineStats`` counts collate time, H2D time, reorder
  depth and starved deliveries (this loader's consumer blocked on the
  next batch: the loop, or the prefetch thread where one sits above),
  flushed by the loop after each pass, once its last copy is recorded,
  into ``utils/tracer.py`` samples under the JAX package's names
  (``pipeline/collate_s``, ``pipeline/h2d_s``, ``pipeline/starved_steps``,
  ``pipeline/queue_depth_avg``) and, with a telemetry stream open, one
  ``pipeline`` row.

Buffer reuse: a delivered batch's tensors share memory with the packed
buffers (``torch.as_tensor``), so a recycled buffer would rewrite a
batch its consumer still holds. With ``recycle`` on, a delivery's
buffers go back to the pool after ``hold`` further deliveries; the
runner turns it on only where the consumer copies each batch to the card
before it takes the next (``parallel/runtime.wrap_loader``), and sizes
``hold`` for what sits between (``parallel/dp.DPLoader.required_hold``).
Everywhere else every batch gets fresh buffers.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np

from hydragnn_tpu_torch.data.graph import (
    GraphBatch,
    PadSpec,
    apply_segment_plan,
    fill_triplets,
)
from hydragnn_tpu_torch.data.loader import (
    MacroBatch,
    drop_consumed_groups,
    skip_delivered_items,
)
from hydragnn_tpu_torch.data.padschedule import superstep_groups
from hydragnn_tpu_torch.ops.edge_pipeline import DEFAULT_BE, DEFAULT_BN


class PipelineStats:
    """Feed counters, accumulated on the consumer (no locks): collate
    time measured in the worker that built each delivery, H2D time
    recorded by the loop, and at each chunk's delivery the reorder
    buffer's depth and whether the consumer had to wait (starved). Under
    a prefetch thread that consumer is the thread, not the loop, whose
    own wait is the step clock's input wait (``utils/telemetry.py``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.delivered = 0
        self.starved_steps = 0
        self.collate_s = 0.0
        self.collate_count = 0
        self.collate_max = 0.0
        self.h2d_s = 0.0
        self.h2d_count = 0
        self.queue_depth_sum = 0
        self.queue_depth_samples = 0
        self.epochs = 0

    def record_collate(self, dt: float) -> None:
        self.collate_s += dt
        self.collate_count += 1
        self.collate_max = max(self.collate_max, dt)

    def record_h2d(self, dt: float, n: int = 1) -> None:
        self.h2d_s += dt
        self.h2d_count += n

    def record_delivery(self, queue_depth: int, starved: bool) -> None:
        self.delivered += 1
        self.queue_depth_sum += queue_depth
        self.queue_depth_samples += 1
        if starved:
            self.starved_steps += 1

    def as_dict(self) -> dict:
        d = {
            "delivered_batches": self.delivered,
            "starved_steps": self.starved_steps,
            "epochs": self.epochs,
            "collate_s_total": round(self.collate_s, 6),
            "collate_s_max": round(self.collate_max, 6),
            "h2d_s_total": round(self.h2d_s, 6),
        }
        if self.collate_count:
            d["collate_ms_avg"] = round(1e3 * self.collate_s / self.collate_count, 3)
        if self.h2d_count:
            d["h2d_ms_avg"] = round(1e3 * self.h2d_s / self.h2d_count, 3)
        if self.queue_depth_samples:
            d["queue_depth_avg"] = round(self.queue_depth_sum / self.queue_depth_samples, 2)
        return d

    def flush_to_tracer(self, prefix: str = "pipeline") -> None:
        """One tracer sample per counter (the running totals), and one
        ``pipeline`` telemetry row when a stream is open. Called by the
        loop after a pass (``train/loop.py``), on its own thread."""
        from hydragnn_tpu_torch.utils import telemetry
        from hydragnn_tpu_torch.utils import tracer as tr

        if telemetry.active():
            telemetry.emit({"t": "pipeline", **self.as_dict()})
        if not tr.has("RegionTimer"):
            return
        tr.sample(f"{prefix}/collate_s", self.collate_s)
        tr.sample(f"{prefix}/h2d_s", self.h2d_s)
        tr.sample(f"{prefix}/starved_steps", float(self.starved_steps))
        if self.queue_depth_samples:
            tr.sample(f"{prefix}/queue_depth_avg",
                      self.queue_depth_sum / self.queue_depth_samples)


# ----------------------------------------------------------------------
# Packed collation into reusable buffers.
# ----------------------------------------------------------------------

def _buf(out: Dict[str, np.ndarray], name: str, shape, dtype) -> np.ndarray:
    """The reusable buffer ``name`` of ``out``, reallocated when its
    shape or dtype changed (a pool entry is keyed by spec, so only
    optional-field widths can change it)."""
    a = out.get(name)
    if a is None or a.shape != tuple(shape) or a.dtype != np.dtype(dtype):
        a = np.empty(tuple(shape), dtype)
        out[name] = a
    return a


def _plans_into_buffers(out, pad: PadSpec, with_segment_plan: bool, senders, receivers,
                        edge_mask, edge_payloads, e_real: int, n_real: int, N: int):
    """The block plan at the Hopper tiles and the triplets, through the
    helpers ``graph.collate`` calls (so the bits are its own by
    construction); triplet buffers come from the pool. Returns
    (seg_perm, seg_ids, seg_valid, seg_window, seg_tile, t_kj, t_ji,
    triplet_mask)."""
    seg_perm = seg_ids = seg_valid = seg_window = seg_tile = None
    if with_segment_plan:
        seg_perm, seg_ids, seg_valid, seg_window = apply_segment_plan(
            senders, receivers, edge_mask, edge_payloads, e_real, N, DEFAULT_BE, DEFAULT_BN)
        seg_tile = (int(DEFAULT_BE), int(DEFAULT_BN))
    t_kj = t_ji = triplet_mask = None
    if pad.num_triplets is not None:
        T = pad.num_triplets
        t_kj = _buf(out, "t_kj", (T,), np.int32)
        t_ji = _buf(out, "t_ji", (T,), np.int32)
        triplet_mask = _buf(out, "triplet_mask", (T,), bool)
        fill_triplets(t_kj, t_ji, triplet_mask, senders, receivers, e_real, n_real)
    return seg_perm, seg_ids, seg_valid, seg_window, seg_tile, t_kj, t_ji, triplet_mask


def _concat_into(dst: np.ndarray, arrs: List[np.ndarray]) -> None:
    """``dst = concat(arrs)`` with assignment-style casting."""
    if len(arrs) == 1:
        dst[...] = arrs[0]
    elif all(getattr(a, "dtype", None) == dst.dtype for a in arrs):
        np.concatenate(arrs, axis=0, out=dst)
    else:
        dst[...] = np.concatenate(arrs, axis=0)


def _check_fits(n_real: int, e_real: int, g_real: int, pad: PadSpec) -> None:
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


def _node_edge_core(out, n_sizes, e_sizes, N: int, E: int, G: int):
    """The fields every batch has, from the per-graph sizes: node graph
    ids, slots and mask, the edge mask, the graph mask, and the padding
    of senders/receivers (their real part is the caller's)."""
    g_real = len(n_sizes)
    n_real, e_real = int(n_sizes.sum()), int(e_sizes.sum())
    node_off = np.concatenate(([0], np.cumsum(n_sizes)[:-1])).astype(np.int64)
    node_graph_idx = _buf(out, "node_graph_idx", (N,), np.int32)
    node_graph_idx[:n_real] = np.repeat(np.arange(g_real), n_sizes)
    node_graph_idx[n_real:] = g_real
    node_slot = _buf(out, "node_slot", (N,), np.int32)
    node_slot[:n_real] = np.arange(n_real) - np.repeat(node_off, n_sizes)
    node_slot[n_real:] = np.arange(N - n_real)
    node_mask = _buf(out, "node_mask", (N,), bool)
    node_mask[:n_real] = True
    node_mask[n_real:] = False
    senders = _buf(out, "senders", (E,), np.int32)
    receivers = _buf(out, "receivers", (E,), np.int32)
    senders[e_real:] = n_real
    receivers[e_real:] = n_real
    edge_mask = _buf(out, "edge_mask", (E,), bool)
    edge_mask[:e_real] = True
    edge_mask[e_real:] = False
    graph_mask = _buf(out, "graph_mask", (G,), bool)
    graph_mask[:g_real] = True
    graph_mask[g_real:] = False
    return node_off, node_graph_idx, node_slot, node_mask, senders, receivers, edge_mask, \
        graph_mask


def _finish(out, pad, with_segment_plan, fields: dict, edge_payloads: dict, e_real: int,
            n_real: int) -> GraphBatch:
    """Attach the plans and build the numpy-backed GraphBatch."""
    (seg_perm, seg_ids, seg_valid, seg_window, seg_tile, t_kj, t_ji,
     triplet_mask) = _plans_into_buffers(
        out, pad, with_segment_plan, fields["senders"], fields["receivers"],
        fields["edge_mask"], edge_payloads, e_real, n_real, pad.num_nodes)
    return GraphBatch(
        **fields, **edge_payloads, t_kj=t_kj, t_ji=t_ji, triplet_mask=triplet_mask,
        seg_perm=seg_perm, seg_ids=seg_ids, seg_valid=seg_valid, seg_window=seg_window,
        seg_tile=seg_tile)


def collate_packed(samples, pad: PadSpec, *, with_segment_plan: bool = False,
                   ensure_fields: Optional[dict] = None,
                   out: Optional[Dict[str, np.ndarray]] = None) -> GraphBatch:
    """``graph.collate(samples, pad, ..., as_numpy=True)`` bit for bit,
    one vectorized op per field instead of a loop over the samples,
    written into the buffer dict ``out`` (filled in place; pass the same
    dict again to reuse its buffers, or None for fresh ones). The
    returned batch's arrays alias ``out``; padding regions are rewritten
    on every call, since a reused buffer arrives dirty."""
    if out is None:
        out = {}
    dtype = np.float32
    g_real = len(samples)
    n_sizes = np.fromiter((s.num_nodes for s in samples), np.int64, count=g_real)
    e_sizes = np.fromiter((s.num_edges for s in samples), np.int64, count=g_real)
    n_real, e_real = int(n_sizes.sum()), int(e_sizes.sum())
    _check_fits(n_real, e_real, g_real, pad)
    N, E, G = pad.num_nodes, pad.num_edges, pad.num_graphs
    (node_off, node_graph_idx, node_slot, node_mask, senders, receivers, edge_mask,
     graph_mask) = _node_edge_core(out, n_sizes, e_sizes, N, E, G)

    f_dim = samples[0].x.shape[1] if samples[0].x.ndim > 1 else 1
    x = _buf(out, "x", (N, f_dim), dtype)
    if n_real:
        _concat_into(x[:n_real], [s.x if s.x.ndim == 2 else s.x.reshape(int(k), -1)
                                  for s, k in zip(samples, n_sizes)])
    x[n_real:] = 0
    if e_real:
        shift = np.repeat(node_off, e_sizes)
        with_edges = [s.edge_index for s, k in zip(samples, e_sizes) if int(k)]
        _concat_into(senders[:e_real], [ei[0] for ei in with_edges])
        senders[:e_real] += shift
        _concat_into(receivers[:e_real], [ei[1] for ei in with_edges])
        receivers[:e_real] += shift

    def _widths(field, vals) -> int:
        dims = {int(np.shape(v)[-1]) if np.shape(v) else 1 for v in vals if v is not None}
        if len(dims) != 1:
            raise ValueError(f"Inconsistent {field} dims across samples: {dims}")
        return dims.pop()

    def _rows(v, k):  # row-aligned fields stored flat or [k, d]
        v = np.asarray(v)
        return v if v.ndim == 2 else v.reshape(k, -1)

    def _opt_rows(field, width_of, sizes, offs, total):
        """A row-aligned optional field as collate fills it: None when
        every sample lacks it (unless ``ensure_fields`` names it), zero
        rows for the samples that lack it."""
        vals = [getattr(s, field) for s in samples]
        n_present = sum(v is not None for v in vals)
        if n_present == 0:
            if ensure_fields and field in ensure_fields:
                buf = _buf(out, field, (width_of, int(ensure_fields[field])), dtype)
                buf[...] = 0
                return buf
            return None
        buf = _buf(out, field, (width_of, _widths(field, vals)), dtype)
        if n_present == g_real:
            if total:
                _concat_into(buf[:total], [_rows(v, int(k)) for v, k in zip(vals, sizes)
                                           if int(k)])
            buf[total:] = 0
        else:
            buf[...] = 0
            for v, k, o in zip(vals, sizes, offs):
                if v is not None and int(k):
                    buf[int(o): int(o) + int(k)] = _rows(v, int(k))
        return buf

    edge_off = np.concatenate(([0], np.cumsum(e_sizes)[:-1])).astype(np.int64)
    node_fields = {f: _opt_rows(f, N, n_sizes, node_off, n_real)
                   for f in ("pos", "forces", "y_node", "pe")}
    edge_payloads = {f: _opt_rows(f, E, e_sizes, edge_off, e_real)
                     for f in ("edge_attr", "edge_shifts", "rel_pe")}

    def _opt_graph(field):
        vals = [getattr(s, field) for s in samples]
        n_present = sum(v is not None for v in vals)
        if n_present == 0:
            if ensure_fields and field in ensure_fields:
                buf = _buf(out, field, (G, int(ensure_fields[field])), dtype)
                buf[...] = 0
                return buf
            return None
        buf = _buf(out, field, (G, _widths(field, vals)), dtype)
        buf[...] = 0
        if n_present == g_real:
            buf[:g_real] = np.stack([np.asarray(v).reshape(-1) for v in vals])
        else:
            for gi, v in enumerate(vals):
                if v is not None:
                    buf[gi] = np.asarray(v).reshape(-1)
        return buf

    cell = None
    if any(s.cell is not None for s in samples) or (ensure_fields and "cell" in ensure_fields):
        cell = _buf(out, "cell", (G, 3, 3), dtype)
        cell[...] = np.eye(3, dtype=dtype)
        for gi, s in enumerate(samples):
            if s.cell is not None:
                cell[gi] = s.cell
    energy = None
    if any(s.energy is not None for s in samples):
        if not all(s.energy is not None for s in samples):
            raise ValueError(
                "Partially-labeled batch: some samples have energy and some do not "
                "(zero-filled targets would silently train toward 0)."
            )
        energy = _buf(out, "energy", (G,), dtype)
        energy[...] = 0
        energy[:g_real] = np.fromiter(
            (float(np.asarray(s.energy).reshape(-1)[0]) for s in samples), np.float64,
            count=g_real)
    if any(s.forces is not None for s in samples) and not all(
            s.forces is not None for s in samples):
        raise ValueError("Partially-labeled batch: some samples have forces and some do not.")
    dataset_id = _buf(out, "dataset_id", (G,), np.int32)
    dataset_id[...] = 0
    dataset_id[:g_real] = np.fromiter((s.dataset_id for s in samples), np.int64, count=g_real)
    fields = dict(x=x, node_graph_idx=node_graph_idx, node_slot=node_slot,
                  node_mask=node_mask, senders=senders, receivers=receivers,
                  edge_mask=edge_mask, graph_mask=graph_mask, y_graph=_opt_graph("y_graph"),
                  graph_attr=_opt_graph("graph_attr"), dataset_id=dataset_id, cell=cell,
                  energy=energy, **node_fields)
    return _finish(out, pad, with_segment_plan, fields, edge_payloads, e_real, n_real)


# ----------------------------------------------------------------------
# Dataset-wide column tables: a batch is a handful of gathers.
# ----------------------------------------------------------------------

_NODE_TABLE_FIELDS = ("pos", "forces", "y_node", "pe")
_EDGE_TABLE_FIELDS = ("edge_attr", "edge_shifts", "rel_pe")
_GRAPH_TABLE_FIELDS = ("y_graph", "graph_attr")


class PackedStore:
    """Column tables over an in-memory dataset, in the collated dtypes
    (float32 and int32, cast once at build), so ``assemble`` gives
    ``graph.collate``'s arrays bit for bit with no per-sample Python.

    ``build`` returns None (and the pipeline collates sample by sample
    with ``collate_packed``) unless the dataset is a materialized list,
    every optional field is present on all samples or on none (mixed
    presence keeps collate's per-batch zero fill, which a table gather
    cannot give) and the widths are consistent. It costs one packed copy
    of the dataset in host memory; ``HYDRAGNN_TPU_PIPELINE_STORE=0``
    turns it off."""

    def __init__(self) -> None:
        self.tables: Dict[str, np.ndarray] = {}
        self.n_sizes = self.e_sizes = self.node_start = self.edge_start = None
        self.f_dim = 1

    @staticmethod
    def build(dataset) -> Optional["PackedStore"]:
        if os.environ.get("HYDRAGNN_TPU_PIPELINE_STORE", "1") in ("0", "false"):
            return None
        if not isinstance(dataset, list) or not dataset:
            return None
        dtype = np.float32
        st = PackedStore()
        n = len(dataset)
        st.n_sizes = np.fromiter((s.num_nodes for s in dataset), np.int64, count=n)
        st.e_sizes = np.fromiter((s.num_edges for s in dataset), np.int64, count=n)
        st.node_start = np.concatenate(([0], np.cumsum(st.n_sizes)[:-1])).astype(np.int64)
        st.edge_start = np.concatenate(([0], np.cumsum(st.e_sizes)[:-1])).astype(np.int64)
        s0 = dataset[0]
        st.f_dim = s0.x.shape[1] if s0.x.ndim > 1 else 1
        try:
            st.tables["x"] = np.concatenate(
                [s.x if s.x.ndim == 2 else s.x.reshape(s.num_nodes, -1) for s in dataset]
            ).astype(dtype, copy=False)
        except ValueError:
            return None  # inconsistent widths: the per-sample path raises
        if st.tables["x"].shape[1] != st.f_dim:
            return None
        for field in (_NODE_TABLE_FIELDS + _EDGE_TABLE_FIELDS + _GRAPH_TABLE_FIELDS
                      + ("cell", "energy", "edge_index")):
            present = sum(getattr(s, field) is not None for s in dataset)
            if 0 < present < n:
                return None
        try:
            if s0.edge_index is not None:
                for name, row in (("snd", 0), ("rcv", 1)):
                    st.tables[name] = np.concatenate(
                        [s.edge_index[row] for s in dataset if s.num_edges]
                        or [np.zeros(0, np.int64)]).astype(np.int32)
            for field in _NODE_TABLE_FIELDS:
                if getattr(s0, field) is not None:
                    st.tables[field] = np.concatenate(
                        [np.asarray(getattr(s, field)).reshape(s.num_nodes, -1)
                         for s in dataset]).astype(dtype, copy=False)
            for field in _EDGE_TABLE_FIELDS:
                if getattr(s0, field) is not None:
                    st.tables[field] = np.concatenate(
                        [np.asarray(getattr(s, field)).reshape(s.num_edges, -1)
                         for s in dataset if s.num_edges]
                        or [np.zeros((0, 1), dtype)]).astype(dtype, copy=False)
            for field in _GRAPH_TABLE_FIELDS:
                if getattr(s0, field) is not None:
                    st.tables[field] = np.stack(
                        [np.asarray(getattr(s, field)).reshape(-1) for s in dataset]
                    ).astype(dtype, copy=False)
            if s0.cell is not None:
                st.tables["cell"] = np.stack([s.cell for s in dataset]).astype(dtype, copy=False)
            if s0.energy is not None:
                st.tables["energy"] = np.fromiter(
                    (float(np.asarray(s.energy).reshape(-1)[0]) for s in dataset), np.float64,
                    count=n).astype(dtype)
            st.tables["dataset_id"] = np.fromiter(
                (s.dataset_id for s in dataset), np.int64, count=n).astype(np.int32)
        except ValueError:
            return None  # ragged widths: the per-sample path raises
        return st

    def assemble(self, idx: np.ndarray, pad: PadSpec, *, with_segment_plan: bool = False,
                 ensure_fields: Optional[dict] = None,
                 out: Optional[Dict[str, np.ndarray]] = None) -> GraphBatch:
        """``collate([dataset[i] for i in idx], pad, ...)`` by gathers,
        under ``collate_packed``'s buffer contract."""
        if out is None:
            out = {}
        dtype = np.float32
        idx = np.asarray(idx)
        g_real = len(idx)
        n_sizes, e_sizes = self.n_sizes[idx], self.e_sizes[idx]
        n_real, e_real = int(n_sizes.sum()), int(e_sizes.sum())
        _check_fits(n_real, e_real, g_real, pad)
        N, E, G = pad.num_nodes, pad.num_edges, pad.num_graphs
        (node_off, node_graph_idx, node_slot, node_mask, senders, receivers, edge_mask,
         graph_mask) = _node_edge_core(out, n_sizes, e_sizes, N, E, G)
        node_rows = np.repeat(self.node_start[idx], n_sizes) + node_slot[:n_real]
        x = _buf(out, "x", (N, self.f_dim), dtype)
        x[:n_real] = self.tables["x"][node_rows]
        x[n_real:] = 0
        edge_rows = np.zeros(0, np.int64)
        if e_real:
            edge_off = np.concatenate(([0], np.cumsum(e_sizes)[:-1]))
            edge_rows = (np.repeat(self.edge_start[idx], e_sizes) + np.arange(e_real)
                         - np.repeat(edge_off, e_sizes))
            shift = np.repeat(node_off, e_sizes)
            senders[:e_real] = self.tables["snd"][edge_rows] + shift
            receivers[:e_real] = self.tables["rcv"][edge_rows] + shift

        def _gather(field, width_of, total, rows):
            tab = self.tables.get(field)
            if tab is None:
                if ensure_fields and field in ensure_fields:
                    buf = _buf(out, field, (width_of, int(ensure_fields[field])), dtype)
                    buf[...] = 0
                    return buf
                return None
            buf = _buf(out, field, (width_of, tab.shape[1]), dtype)
            buf[:total] = tab[rows]
            buf[total:] = 0
            return buf

        node_fields = {f: _gather(f, N, n_real, node_rows) for f in _NODE_TABLE_FIELDS}
        edge_payloads = {f: _gather(f, E, e_real, edge_rows) for f in _EDGE_TABLE_FIELDS}
        cell = None
        if "cell" in self.tables or (ensure_fields and "cell" in ensure_fields):
            cell = _buf(out, "cell", (G, 3, 3), dtype)
            cell[...] = np.eye(3, dtype=dtype)
            if "cell" in self.tables:
                cell[:g_real] = self.tables["cell"][idx]
        energy = None
        if "energy" in self.tables:
            energy = _buf(out, "energy", (G,), dtype)
            energy[g_real:] = 0
            energy[:g_real] = self.tables["energy"][idx]
        dataset_id = _buf(out, "dataset_id", (G,), np.int32)
        dataset_id[g_real:] = 0
        dataset_id[:g_real] = self.tables["dataset_id"][idx]
        fields = dict(x=x, node_graph_idx=node_graph_idx, node_slot=node_slot,
                      node_mask=node_mask, senders=senders, receivers=receivers,
                      edge_mask=edge_mask, graph_mask=graph_mask,
                      y_graph=_gather("y_graph", G, g_real, idx),
                      graph_attr=_gather("graph_attr", G, g_real, idx),
                      dataset_id=dataset_id, cell=cell, energy=energy, **node_fields)
        return _finish(out, pad, with_segment_plan, fields, edge_payloads, e_real, n_real)


# ----------------------------------------------------------------------
# The pipeline loader.
# ----------------------------------------------------------------------

def _spec_key(spec: PadSpec) -> tuple:
    return (spec.num_nodes, spec.num_edges, spec.num_graphs, spec.num_triplets)


def owned_copy(item):
    """A delivery (a batch or a ``MacroBatch``) whose tensors own their
    memory: what a replay cache keeps of a recycled delivery."""
    if isinstance(item, MacroBatch):
        return MacroBatch([owned_copy(b) for b in item.batches])
    return dataclasses.replace(item, **{k: v.clone() for k, v in item.arrays().items()})


class ParallelPipelineLoader:
    """The parallel feed over a ``GraphLoader`` (module docstring): its
    epoch plan collated by ``workers`` threads and delivered in order,
    bit for bit the serial loader's batches (``SuperstepLoader``'s
    deliveries with ``superstep_k`` > 1).

    ``depth`` chunks are in flight at most, which also caps the threads
    collating at once at ``min(workers, depth)``; ``chunk`` batches make
    one task (1 under supersteps, where a group is the task). ``packed``
    assembles into pooled buffers through ``PackedStore`` where the
    dataset is eligible, else ``collate_packed``; off, each batch is the
    loader's own ``collate_entry``. ``recycle`` and ``hold``: the module
    docstring.

    A fixed-order loader with ``cache_batches`` has its first full
    epoch kept (owned copies where buffers recycle) and replayed after;
    ``skip_to(step)`` drops the plan entries (superstep groups cut from
    the whole plan) a cursor covers before any reaches a worker."""

    def __init__(self, loader, *, workers: int = 4, depth: int = 4, packed: bool = True,
                 chunk: int = 4, superstep_k: int = 1, recycle: bool = False, hold: int = 2):
        if int(workers) < 1:
            raise ValueError(
                "ParallelPipelineLoader needs workers >= 1; workers 0 is the serial feed "
                "(with the prefetch thread, data/prefetch.PrefetchLoader)"
            )
        if not hasattr(loader, "epoch_plan"):
            raise TypeError(
                "ParallelPipelineLoader wraps a GraphLoader (it collates loader.epoch_plan); "
                f"got {type(loader)}"
            )
        self.loader = loader
        self.workers = int(workers)
        self.depth = max(1, int(depth))
        self.packed = bool(packed)
        self.chunk = max(1, int(chunk))
        self.superstep_k = max(1, int(superstep_k))
        self.recycle = bool(recycle)
        self.hold = max(2, int(hold))
        self.stats = PipelineStats()
        self._skip_next = 0
        self._cache: Optional[list] = None  # grouped deliveries (superstep_k > 1)
        self._store: Optional[PackedStore] = None
        self._store_tried = False
        self._pool: Dict[tuple, List[dict]] = {}
        self._pool_lock = threading.Lock()

    # -- loader protocol ------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)
        self._skip_next = 0  # a cursor never outlives its epoch

    def skip_to(self, step: int) -> None:
        """The next iteration starts at optimizer step ``step`` of the
        epoch; the consumed entries are planned but never collated."""
        self._skip_next = max(0, int(step))

    def __len__(self) -> int:
        """Deliveries this epoch (superstep groups when grouping)."""
        if self.superstep_k > 1:
            return len(superstep_groups(self.loader.epoch_plan(self.loader._epoch),
                                        self.superstep_k))
        return len(self.loader)

    # -- buffer pool ----------------------------------------------------
    def _pool_acquire(self, key: tuple) -> dict:
        if not self.recycle:
            return {}
        with self._pool_lock:
            free = self._pool.get(key)
            return free.pop() if free else {}

    def _pool_release(self, bufs: list) -> None:
        if not self.recycle:
            return
        with self._pool_lock:
            for key, b in bufs:
                self._pool.setdefault(key, []).append(b)

    # -- worker side ----------------------------------------------------
    def _collate_entry(self, idx, spec) -> tuple:
        """One plan entry's batch (CPU tensors, as ``collate`` gives
        them) and its pool buffers ``[(key, dict)]``."""
        loader = self.loader
        if not self.packed:
            return loader.collate_entry(idx, spec), []
        samples = None
        if spec is None:  # the triplet ladder: the batch's own spec
            samples = [loader.dataset[i] for i in idx]
            spec = PadSpec.for_samples(samples, with_triplets=loader.with_triplets)
        key = _spec_key(spec)
        bufs = self._pool_acquire(key)
        kw = dict(with_segment_plan=loader.with_segment_plan,
                  ensure_fields=loader._ensure_fields, out=bufs)
        try:
            if self._store is not None:
                batch = self._store.assemble(idx, spec, **kw)
            else:
                if samples is None:
                    samples = [loader.dataset[i] for i in idx]
                batch = collate_packed(samples, spec, **kw)
        except BaseException:
            self._pool_release([(key, bufs)])
            raise
        return batch.to("cpu"), [(key, bufs)]

    def _collate_group(self, group) -> tuple:
        """``("ok", item, bufs, seconds)`` for one group (a batch, or a
        ``MacroBatch`` of the group's batches), or ``("err", exc)``."""
        t0 = time.perf_counter()
        bufs: list = []
        try:
            batches = []
            for idx, spec in group:
                batch, b = self._collate_entry(idx, spec)
                batches.append(batch)
                bufs += b
            item = MacroBatch(batches) if len(batches) > 1 else batches[0]
            return ("ok", item, bufs, time.perf_counter() - t0)
        except BaseException as e:  # raised on the consumer, in order
            self._pool_release(bufs)
            return ("err", e)

    def _worker_main(self, tasks, results, cond, tokens, stop) -> None:
        while not stop.is_set():
            # The token comes before the task: tasks queue in delivery
            # order, so the token holders are always the chunks the
            # consumer needs next (task-then-token deadlocks once workers
            # outnumber the tokens). Polled, so shutdown never hangs.
            while not tokens.acquire(timeout=0.05):
                if stop.is_set():
                    return
            try:
                task = tasks.get_nowait()
            except queue.Empty:
                task = None
            if task is None:  # sentinel: pass the token on to a sibling
                tokens.release()
                return
            cseq, groups = task
            items = []
            for group in groups:
                if stop.is_set():
                    break
                items.append(self._collate_group(group))
                if items[-1][0] == "err":
                    break  # the chunk's later batches are unreachable
            with cond:
                results[cseq] = items
                cond.notify_all()

    # -- consumer side --------------------------------------------------
    def _pop_chunk(self, results, cond, tokens, threads, cseq) -> list:
        starved = False
        with cond:
            while cseq not in results:
                starved = True
                cond.wait(timeout=0.5)
                if cseq not in results and not any(t.is_alive() for t in threads):
                    raise RuntimeError(
                        f"input pipeline workers exited without producing chunk {cseq}")
            items = results.pop(cseq)
            depth = len(results)
        tokens.release()
        self.stats.record_delivery(depth, starved)
        return items

    def iter_groups(self, groups: list) -> Iterator:
        """Collate ``groups`` (lists of ``(idx, spec)`` plan entries) in
        the workers and deliver them in order: a one-entry group as a
        batch, a longer one as a ``MacroBatch``. The feed of this
        loader's own epochs and of a ``DPLoader`` over it (this rank's
        slot of each step)."""
        if self.packed and not self._store_tried:
            self._store = PackedStore.build(self.loader.dataset)
            self._store_tried = True
        n = len(groups)
        if n == 0:
            return
        eff_chunk = 1 if any(len(g) > 1 for g in groups) else self.chunk
        tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        n_chunks = 0
        for start in range(0, n, eff_chunk):
            tasks.put((n_chunks, groups[start: start + eff_chunk]))
            n_chunks += 1
        for _ in range(self.workers):
            tasks.put(None)
        results: Dict[int, list] = {}
        cond = threading.Condition()
        tokens = threading.BoundedSemaphore(self.depth)
        stop = threading.Event()
        threads = [threading.Thread(target=self._worker_main,
                                    args=(tasks, results, cond, tokens, stop),
                                    daemon=True, name=f"hgtpu-pipeline-w{w}")
                   for w in range(self.workers)]
        for t in threads:
            t.start()
        recycle: deque = deque()
        try:
            delivered = 0
            for cseq in range(n_chunks):
                for it in self._pop_chunk(results, cond, tokens, threads, cseq):
                    if it[0] == "err":
                        raise it[1]
                    _, item, bufs, dt = it
                    self.stats.record_collate(dt)
                    recycle.append(bufs)
                    # this delivery and the `hold` before it stay out of
                    # the pool: a delivery is released at the next one
                    # after its `hold` further deliveries
                    while len(recycle) > self.hold + 1:
                        self._pool_release(recycle.popleft())
                    delivered += 1
                    yield item
            if delivered != n:  # a worker stopped a chunk short
                raise RuntimeError(f"input pipeline delivered {delivered}/{n} batches")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)
            for bufs in recycle:
                self._pool_release(bufs)
            with cond:
                leftovers = [it for items in results.values() for it in items]
                results.clear()
            for it in leftovers:
                if it[0] == "ok":
                    self._pool_release(it[2])

    def __iter__(self) -> Iterator:
        skip, self._skip_next = self._skip_next, 0
        loader = self.loader
        grouped = self.superstep_k > 1
        ready = self._cache if grouped else loader._batch_cache
        if ready is not None:
            yield from (skip_delivered_items(ready, skip) if grouped else ready[skip:])
            self.stats.epochs += 1
            return
        plan = list(loader.epoch_plan(loader._epoch))
        if grouped:
            groups = drop_consumed_groups(superstep_groups(plan, self.superstep_k), skip)
        else:
            groups = [[entry] for entry in plan[skip:]]
        cache = [] if loader.cache_batches and not skip else None
        feed = self.iter_groups(groups)
        try:
            for item in feed:
                if cache is not None:
                    cache.append(owned_copy(item) if self.recycle else item)
                yield item
            if cache is not None:
                if grouped:
                    self._cache = cache
                else:
                    loader._batch_cache = cache
            self.stats.epochs += 1
        finally:
            feed.close()  # stops the workers when the consumer left early


def pipeline_stats(loader) -> Optional[PipelineStats]:
    """The stats of the ``ParallelPipelineLoader`` in a wrapper chain
    (each wrapper exposes ``.loader``), or None without one."""
    depth = 0
    while loader is not None and depth < 8:
        if isinstance(loader, ParallelPipelineLoader):
            return loader.stats
        loader, depth = getattr(loader, "loader", None), depth + 1
    return None
