"""Request-level inference engine over fitted pack shapes.

Counterpart of ``hydragnn_tpu/serve/engine.py``: ``ServingSettings``,
``serving_settings``, ``fit_serving_budgets`` and ``ServingEngine``.

The engine holds one executable per fitted ``PackSpec`` budget: the
inference forward (``export.make_forward``: eval mode, the raw head
tuple, or with ``with_forces`` the MLIP pair (graph energies, forces)),
or a program loaded from an exported artifact (``from_exported`` ->
``install_executables``). It runs each once at start (``warm_all``), so
the kernel library is built and every budget shape has run before
traffic. On a card it then captures each executable at its budget as a
CUDA graph (``train/capture.StepGraphs``), the counterpart of the JAX
engine's one compiled executable per budget; each dispatch copies its
bin into that budget's static buffers (one pinned copy) and replays the
graph, and the outputs are copied out of the graph's buffers at once,
so a later replay cannot overwrite a bin still in flight. No dispatch
ever captures: a bin whose shape has no executable raises. Served
outputs equal a direct forward's on the same batch.

Every bin is collated WITH the sorted-segment block plan, so on a CUDA
device each receiver sum runs the hand-written K1 kernel, and the force
pass of a served potential runs K2 (the JAX engine collates without a
plan and stays on XLA's scatter).

Each engine serves its own copy of the module, made from the admitted
snapshot on its device; the caller's model is never changed. A captured
graph holds its parameters' addresses, so engines that shared a module
(the tier's replicas, a rollover's new generation beside the old) would
change each other's weights.

Dispatch is double-buffered as in the JAX engine: bin t+1 is collated,
copied to the device and launched before bin t's outputs are fetched,
so the host's collate overlaps the device's work. The fetch is the one
host sync of the loop.

A snapshot must pass the admission gate (``serve/admission.py``) before
the engine warms. Every resolved bin emits a ``serve`` telemetry row and
``rollup`` a ``serve_rollup`` row (docs/OBSERVABILITY.md's serving
schema): to the replica's own stream when the fleet tier wires one
(``stream=``, ``replica=``), else to the process's active stream
(``utils/telemetry.emit``, a no-op when none is installed).
"""

from __future__ import annotations

import copy
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from hydragnn_tpu_torch.data.graph import GraphSample, PackSpec, collate
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.export import make_forward
from hydragnn_tpu_torch.serve.admission import admit_state
from hydragnn_tpu_torch.serve.batcher import DynamicBatcher, ServeRequest
from hydragnn_tpu_torch.train.capture import GRAPH_LOCK, StepGraphs
from hydragnn_tpu_torch.utils import telemetry


@dataclass(frozen=True)
class ServingSettings:
    """Resolved top-level ``Serving`` config block: ``deadline_ms``
    bounds how long a partial bin waits; ``max_open_bins`` bounds
    concurrent fills; ``batch_size`` / ``max_budgets`` / ``slack`` /
    ``max_graphs`` parameterize the budget fit; ``validate_snapshot``
    gates admission."""

    enabled: bool = False
    deadline_ms: float = 25.0
    max_open_bins: int = 4
    batch_size: int = 32
    max_budgets: int = 2
    slack: Optional[float] = None
    max_graphs: Optional[int] = None
    validate_snapshot: bool = True


def serving_settings(config: dict) -> ServingSettings:
    """Resolve the top-level ``Serving`` block (``true`` is shorthand
    for ``{"enabled": true}``)."""
    raw = config.get("Serving") or {}
    if isinstance(raw, bool):
        raw = {"enabled": raw}
    elif not isinstance(raw, dict):
        raise ValueError(
            "Serving must be a bool or an object "
            '{"enabled", "deadline_ms", "max_open_bins", "batch_size", '
            '"max_budgets", "slack", "max_graphs", "validate_snapshot"}'
        )
    return ServingSettings(
        enabled=bool(raw.get("enabled", False)),
        deadline_ms=float(raw.get("deadline_ms", 25.0)),
        max_open_bins=max(1, int(raw.get("max_open_bins", 4))),
        batch_size=max(1, int(raw.get("batch_size", 32))),
        max_budgets=max(1, int(raw.get("max_budgets", 2))),
        slack=None if raw.get("slack") is None else float(raw["slack"]),
        max_graphs=None if raw.get("max_graphs") is None else int(raw["max_graphs"]),
        validate_snapshot=bool(raw.get("validate_snapshot", True)),
    )


def fit_serving_budgets(
    node_sizes, edge_sizes, settings: ServingSettings, *, seed: int = 0
) -> List[PackSpec]:
    """Fit the serving shape set from a size histogram, with the same
    fit the packed training path uses."""
    from hydragnn_tpu_torch.data.padschedule import fit_pack_budgets

    return fit_pack_budgets(
        np.asarray(node_sizes, np.int64),
        np.asarray(edge_sizes, np.int64),
        settings.batch_size,
        max_budgets=settings.max_budgets,
        slack=settings.slack,
        max_graphs=settings.max_graphs,
        seed=int(seed),
    )


def _spec_key(spec: PackSpec) -> Tuple[int, int, int]:
    return (spec.num_nodes, spec.num_edges, spec.num_graphs)


class ServingEngine:
    """Warm inference over dynamic bins (module docstring).

    ``model`` is the port's model and ``state`` a ``state_dict`` to
    serve (``None`` serves the model's own weights); the engine serves a
    copy of it. ``example`` is one representative GraphSample: its
    optional fields define the batch structure (requests must carry the
    same fields, or ``ensure_fields`` names the ones to zero-fill, as the
    training loaders do) and it is the warm-up payload. ``with_forces``
    serves (graph energies, forces). ``warm=False`` builds no executable
    (for ``install_executables``). ``stream``/``replica`` are the fleet
    tier's wiring. ``device=None`` means ``"cuda"``; without a card that
    raises.
    """

    def __init__(
        self,
        model,
        cfg,
        state: Optional[Mapping[str, torch.Tensor]],
        budgets: List[PackSpec],
        *,
        example: GraphSample,
        settings: Optional[ServingSettings] = None,
        ensure_fields: Optional[dict] = None,
        with_forces: bool = False,
        warm: bool = True,
        stream=None,
        replica: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.settings = settings or ServingSettings(enabled=True)
        self.cfg = cfg
        self.with_forces = bool(with_forces)
        # Fleet wiring: ``stream`` is the replica's own shard (replicas
        # are threads of one process), ``replica`` tags every row.
        self._stream = stream
        self.replica = None if replica is None else int(replica)
        self._closed = False
        self.budgets = list(budgets)
        if not self.budgets:
            raise ValueError("ServingEngine needs at least one budget")
        self._ensure_fields = dict(ensure_fields or {})
        self._example = example
        if self.settings.validate_snapshot:
            # A non-finite snapshot never warms a single shape.
            admit_state(
                model.state_dict() if state is None else state,
                source="serving snapshot",
            )
        self.model = copy.deepcopy(model)
        if state is not None:
            self.model.load_state_dict(state)
        self.model.to(self.device)
        self._forward = make_forward(self.model, cfg, with_forces=self.with_forces)
        self.graphs = StepGraphs(self.device) if self.device.type == "cuda" else None
        # Executable per budget shape; on a card its graph is kept under
        # the same key.
        self._exec: Dict[Tuple[int, int, int], Callable] = {}
        self.warmup_ms: Dict[Tuple[int, int, int], float] = {}
        # Executables warmed (on a card: graphs captured); a dispatch
        # never adds one.
        self.warm_runs = 0
        self.dispatches = 0
        self.served_requests = 0
        # Bounded retention: the per-bin records and the latency
        # reservoir are windows; running totals carry the full run.
        self._records: deque = deque(maxlen=4096)
        self._lat: deque = deque(maxlen=65536)
        self._agg = self._fresh_agg()
        if warm:
            self.warm_all()

    def _emit(self, row: dict) -> None:
        """One telemetry row to the replica's stream when fleet-wired,
        else to the process's active stream; tagged with the replica."""
        if self.replica is not None:
            row["replica"] = self.replica
        if self._stream is not None:
            self._stream.emit(row)
        else:
            telemetry.emit(row)

    @staticmethod
    def _fresh_agg() -> dict:
        return {
            "graphs": 0,
            "requests": 0,
            "dispatches": 0,
            "exe_nodes": 0,
            "exe_edges": 0,
            "real_nodes": 0,
            "real_edges": 0,
            "reasons": {},
            "t_first": None,
            "t_last": None,
        }

    def reset_stats(self) -> None:
        """Drop every retained record, latency sample and running total
        (the load bench separates its calibration probe from the
        measured stream with this)."""
        self._records.clear()
        self._lat.clear()
        self._agg = self._fresh_agg()
        self.served_requests = 0
        self.dispatches = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- startup -------------------------------------------------------

    def collate_bin(self, samples: List[GraphSample], spec: PackSpec):
        """The host batch the engine serves for ``samples`` at ``spec``
        (with the block plan attached)."""
        return collate(
            samples,
            spec.pad_spec(),
            with_segment_plan=True,
            ensure_fields=self._ensure_fields,
            as_numpy=True,
        )

    def _warm(self, spec: PackSpec, fn: Callable):
        """Run ``fn`` once at ``spec`` (building the kernel library on
        the first), then on a card record its graph, which the caller
        keeps (``_adopt``) or releases. A capture that fails raises.
        Returns the graph (None on the CPU) and the milliseconds."""
        t0 = time.perf_counter()
        host = [self.collate_bin([self._example], spec)]
        captured = None
        if self.graphs is None:
            fn(host[0].to(self.device))
        else:
            step = lambda batches: fn(batches[0])  # noqa: E731
            self.graphs.eager(step, host)
            # a warm-up capture is deliberate: never a retrace leak
            with telemetry.suppress_compile_events():
                captured = self.graphs.record(step, host)
        self._sync()
        return captured, round(1e3 * (time.perf_counter() - t0), 3)

    def _adopt(self, key, fn: Callable, captured, ms: float) -> None:
        """Serve ``fn`` (and its graph) for the budget shape ``key``."""
        if captured is not None:
            self.graphs.put(key, captured)
        self._exec[key] = fn
        self.warm_runs += 1
        self.warmup_ms[key] = ms

    def warm_all(self) -> None:
        """Run the inference forward once per budget shape, then on a
        card capture it, so no shape is first seen under traffic."""
        for b in self.budgets:
            key = _spec_key(b)
            if key not in self._exec:
                self._adopt(key, self._forward, *self._warm(b, self._forward))

    @staticmethod
    def from_exported(
        artifacts: Dict[Tuple[int, int, int], Union[bytes, str]],
        *,
        device: Optional[Union[str, torch.device]] = None,
    ) -> Dict[Tuple[int, int, int], Callable]:
        """Load one exported artifact per budget shape into the
        executable-map form ``{(N, E, G): fn(batch)}`` on ``device``
        (``export.load_exported``; ``None`` means ``"cuda"``): the
        offline deployment, which needs no checkpoint. The map plugs
        into ``install_executables``."""
        from hydragnn_tpu_torch.export import load_exported

        return {
            tuple(key): load_exported(src, device=device)
            for key, src in artifacts.items()
        }

    def install_executables(
        self, execs: Dict[Tuple[int, int, int], Callable]
    ) -> None:
        """Replace or extend the executable map (exported-artifact
        deployments). Every budget shape, the smaller downshift targets
        included, must have an executable after the merge, or this
        raises before anything changes. Each new executable is then run
        once at its shape and, on a card, captured; only when all of
        them warmed does the engine serve them, releasing the graphs they
        replace. A failure releases the graphs already captured and
        leaves the engine as it was: its executables, graphs, warm-up
        counts and device memory."""
        if self._closed:
            raise RuntimeError(
                "ServingEngine is closed — installing executables into a "
                "torn-down engine would resurrect it half-alive"
            )
        merged = dict(self._exec)
        merged.update({tuple(k): v for k, v in execs.items()})
        missing = [
            _spec_key(b) for b in self.budgets if _spec_key(b) not in merged
        ]
        if missing:
            raise ValueError(
                f"executable map does not cover budget shape(s) {missing} — a "
                "bin downshifted to any of them would fail at dispatch; export "
                "one artifact per budget shape"
            )
        by_key = {_spec_key(b): b for b in self.budgets}
        warmed = []
        try:
            for key, fn in execs.items():
                key = tuple(key)
                warmed.append((key, fn, *self._warm(by_key.get(key) or PackSpec(*key), fn)))
        except BaseException:
            if self.graphs is not None:
                self.graphs.release(*(w[2] for w in warmed))
            raise
        for w in warmed:
            self._adopt(*w)

    # -- the dispatch loop (the serving hot path) ----------------------

    def _dispatch(self, batcher: DynamicBatcher, reason: str, b) -> dict:
        """Collate + H2D + launch ONE bin; returns the in-flight record
        ``_resolve`` completes. No host sync here."""
        if self._closed:
            raise RuntimeError(
                "ServingEngine is closed — a closed engine must never "
                "dispatch (the fleet tier's rollover relies on this being loud)"
            )
        reqs = batcher.bin_requests(b)
        spec = batcher.bin_spec(b)
        key = _spec_key(spec)
        ex = self._exec.get(key)
        if ex is None:
            raise RuntimeError(
                f"no warm executable for dispatched shape {key} — the "
                "batcher's budget set must equal the engine's; warm "
                f"shapes: {sorted(self._exec)}"
            )
        t_start = batcher.clock()
        t0 = time.perf_counter()
        samples = [r.sample for r in reqs]
        batch = self.collate_bin(samples, spec)
        offsets = []
        off = 0
        for s in samples:
            offsets.append((off, s.num_nodes))
            off += s.num_nodes
        if self.graphs is None:
            outs = ex(batch.to(self.device))
        else:
            with GRAPH_LOCK:
                outs = tuple(o.clone() for o in self.graphs.replay(key, [batch]))
        t1 = time.perf_counter()
        self.dispatches += 1
        return {
            "reqs": reqs,
            "offsets": offsets,
            "outs": outs,
            "spec": spec,
            "key": key,
            "reason": reason,
            "clock": batcher.clock,
            "queue_depth": batcher.qsize(),
            "tot_nodes": b.tot_nodes,
            "tot_edges": b.tot_edges,
            "t_bin0": b.meta.get("t0"),
            "t_start": t_start,
            "t_collate": t0,
            "t_dispatch": t1,
        }

    def _split_outputs(self, outs_host, rec) -> None:
        """Per-request slices of the padded outputs: graph-level outputs
        index the request's graph slot, node-level ones its node rows
        (the MLIP pair: energies by graph, forces by node)."""
        if self.with_forces:
            levels = [("graph", None), ("node", None)]
        else:
            levels = [(h.type, h.dim) for h in self.cfg.heads]
        for gi, req in enumerate(rec["reqs"]):
            off, n = rec["offsets"][gi]
            result = []
            for hi, (level, dim) in enumerate(levels):
                out = outs_host[hi]
                if dim is not None:
                    out = out[..., :dim]
                result.append(out[gi] if level == "graph" else out[off : off + n])
            req.result = result

    def _resolve(self, rec: dict) -> dict:
        """Fetch one in-flight bin's outputs and complete its requests —
        the one host sync of the loop, made under ``GRAPH_LOCK`` as every
        CUDA call that may meet another thread's capture is
        (``train/capture.py``)."""
        t0 = time.perf_counter()
        with GRAPH_LOCK:
            # graftlint: disable-next-line=host-sync -- the response fetch: the one designed sync of the serving path, paid AFTER the next bin was already dispatched (double buffering)
            outs_host = [o.cpu().numpy() for o in rec["outs"]]
        t_done = rec["clock"]()
        fetch_ms = round(1e3 * (time.perf_counter() - t0), 4)
        self._split_outputs(outs_host, rec)
        for req in rec["reqs"]:
            req.t_done = t_done
            req.latency_ms = round(1e3 * (t_done - req.t_enqueue), 4)
        self.served_requests += len(rec["reqs"])
        spec = rec["spec"]
        row = {
            "t": "serve",
            "spec": f"n{spec.num_nodes}_e{spec.num_edges}_g{spec.num_graphs}",
            "reason": rec["reason"],
            "graphs": len(rec["reqs"]),
            "nodes": rec["tot_nodes"],
            "edges": rec["tot_edges"],
            "nodes_pad": spec.num_nodes,
            "edges_pad": spec.num_edges,
            "graphs_pad": spec.num_graphs,
            "queue_depth": rec["queue_depth"],
            "dispatch_ms": round(1e3 * (rec["t_dispatch"] - rec["t_collate"]), 4),
            "fetch_ms": fetch_ms,
        }
        if rec["t_bin0"] is not None:
            row["bin_wait_ms"] = round(1e3 * (t_done - rec["t_bin0"]), 4)
        self._emit(row)
        done = dict(rec)
        done["t_done"] = t_done
        done["fetch_ms"] = fetch_ms
        done.pop("outs")  # device tensors are never retained past the fetch
        self._records.append(done)
        agg = self._agg
        agg["graphs"] += len(rec["reqs"])
        agg["requests"] += len(rec["reqs"])
        agg["dispatches"] += 1
        agg["exe_nodes"] += spec.num_nodes
        agg["exe_edges"] += spec.num_edges
        agg["real_nodes"] += rec["tot_nodes"]
        agg["real_edges"] += rec["tot_edges"]
        agg["reasons"][rec["reason"]] = agg["reasons"].get(rec["reason"], 0) + 1
        if agg["t_first"] is None:
            agg["t_first"] = rec["t_start"]
        agg["t_last"] = t_done
        for req in rec["reqs"]:
            self._lat.append(req.latency_ms)
        return done

    def process(
        self,
        batcher: DynamicBatcher,
        *,
        timeout: float = 0.2,
        stop: Optional[Callable[[], bool]] = None,
    ) -> List[dict]:
        """Drive the dispatch loop: pull bins from the batcher, dispatch
        double-buffered, resolve responses. Returns the resolved bin
        records. Exits when the batcher is closed and drained; an idle wait of ``timeout`` resolves a pending
        bin, so a lone request never waits for a successor.

        ``stop`` is the fleet tier's kill hook: checked between bins, a
        True return abandons the loop at once, any in-flight bin dropped
        unresolved, as a killed process would; the tier's re-route then
        recovers the abandoned requests. Graceful teardown never passes
        ``stop`` (it closes the batcher and lets the loop drain)."""
        pending: Optional[dict] = None
        done: List[dict] = []
        while True:
            if stop is not None and stop():
                return done
            item = batcher.next_bin(timeout=timeout)
            if item is None:
                if pending is not None:
                    done.append(self._resolve(pending))
                    pending = None
                    continue
                if batcher._closed:
                    break
                continue
            reason, b = item
            rec = self._dispatch(batcher, reason, b)
            if pending is not None:
                # Fetch the PREVIOUS bin only now: its device time
                # overlapped this bin's collate + H2D + launch.
                done.append(self._resolve(pending))
            pending = rec
        if pending is not None:
            done.append(self._resolve(pending))
        return done

    # -- lifecycle -----------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def drain(self, batcher: DynamicBatcher, *, timeout: float = 0.05) -> List[dict]:
        """Close the batcher and serve everything still queued or in open
        bins: every accepted request gets its response before the engine
        goes away (the rollover's drain of the old generation).
        Idempotent; returns [] on a closed engine."""
        batcher.close()
        if self._closed:
            return []
        return self.process(batcher, timeout=timeout)

    def close(self) -> None:
        """Tear down: drop the executables, their graphs and the retained
        records; any later dispatch raises. Idempotent; aggregates survive
        so ``rollup(emit=False)`` still reports a closed engine's run."""
        if self._closed:
            return
        self._closed = True
        self._exec = {}
        if self.graphs is not None:
            self.graphs.clear()
        self.graphs = None
        self._records.clear()

    # -- reporting -----------------------------------------------------

    def rollup(self, *, emit: bool = True) -> dict:
        """The serving report row (``serve_rollup``): p50/p99 request
        latency over the recent latency reservoir, graphs/s over the busy
        window, per-dimension fill and slot waste from the run's running
        totals. ``emit`` sends it to the telemetry stream too."""
        agg = self._agg
        lat = np.asarray(self._lat, dtype=np.float64)
        row = {
            "t": "serve_rollup",
            "requests": int(agg["requests"]),
            "graphs": int(agg["graphs"]),
            "dispatches": int(agg["dispatches"]),
            "shapes": len(self._exec),
        }
        if lat.size:
            row["p50_ms"] = round(float(np.percentile(lat, 50)), 4)
            row["p99_ms"] = round(float(np.percentile(lat, 99)), 4)
            row["max_ms"] = round(float(lat.max()), 4)
            row["mean_ms"] = round(float(lat.mean()), 4)
        if agg["dispatches"]:
            busy = agg["t_last"] - agg["t_first"]
            if busy > 0:
                row["graphs_per_sec"] = round(agg["graphs"] / busy, 3)
            exe_n, exe_e = agg["exe_nodes"], agg["exe_edges"]
            real_n, real_e = agg["real_nodes"], agg["real_edges"]
            row["node_fill"] = round(real_n / max(exe_n, 1), 4)
            row["edge_fill"] = round(real_e / max(exe_e, 1), 4)
            row["slot_waste"] = round(1.0 - (real_n + real_e) / max(exe_n + exe_e, 1), 4)
            row["dispatch_reasons"] = dict(agg["reasons"])
        if emit:
            self._emit(row)
        return row
