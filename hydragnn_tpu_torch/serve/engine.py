"""Request-level inference engine over fitted pack shapes.

Counterpart of ``hydragnn_tpu/serve/engine.py``: ``ServingSettings``,
``serving_settings``, ``fit_serving_budgets`` and ``ServingEngine``.

The engine holds one inference forward (``export.make_forward``: eval
mode, no gradients, the raw head tuple) on one device and runs one
warm-up forward per fitted ``PackSpec`` budget at start, so the kernel
library is built and every budget shape has run once before traffic.
On a card the warm-up then captures the forward at each budget as a
CUDA graph (``train/capture.StepGraphs``), the counterpart of the JAX
engine's one compiled executable per budget, and each dispatch copies
its bin into that budget's static buffers (one pinned copy) and replays
the graph; the outputs are copied out of the graph's buffers at once, so
a later replay cannot overwrite a bin that is still in flight. Served
outputs equal a direct forward's on the same batch.
Every bin is collated WITH the sorted-segment block plan, so on a CUDA
device each CFConv layer's edge pipeline runs the hand-written K1
kernel (the JAX engine collates without a plan and stays on XLA's
scatter).

Dispatch is double-buffered as in the JAX engine: bin t+1 is collated,
copied to the device and launched before bin t's outputs are fetched,
so the host's collate overlaps the device's work. The fetch is the one
host sync of the loop.

A snapshot must pass the admission gate (``serve/admission.py``) before
the engine warms. Not ported yet: telemetry rows (the engine keeps its
running totals and ``rollup()`` returns them, but emits nothing until
telemetry is ported, ROADMAP Queue 1 item 13), the fleet wiring and
its hooks, executables installed from exported artifacts, the MLIP
``with_forces`` form and ``ensure_fields`` for mixed datasets (item 14).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from hydragnn_tpu_torch.data.graph import GraphSample, PackSpec, collate
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.export import make_forward
from hydragnn_tpu_torch.serve.admission import admit_state
from hydragnn_tpu_torch.serve.batcher import DynamicBatcher, ServeRequest
from hydragnn_tpu_torch.train.capture import StepGraphs


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
    serve (``None`` serves the model's own weights). ``example`` is one
    representative GraphSample: its optional fields define the batch
    structure and it is the warm-up payload. ``device=None`` means
    ``"cuda"``; without a card that raises.
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
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.settings = settings or ServingSettings(enabled=True)
        self.cfg = cfg
        self.budgets = list(budgets)
        if not self.budgets:
            raise ValueError("ServingEngine needs at least one budget")
        self._example = example
        if self.settings.validate_snapshot:
            # A non-finite snapshot never warms a single shape.
            admit_state(
                model.state_dict() if state is None else state,
                source="serving snapshot",
            )
        if state is not None:
            model.load_state_dict(state)
        model.to(self.device)
        self._forward = make_forward(model, cfg)
        self.graphs = StepGraphs(self.device) if self.device.type == "cuda" else None
        self._warm: Dict[Tuple[int, int, int], bool] = {}
        self.warmup_ms: Dict[Tuple[int, int, int], float] = {}
        self._closed = False
        # Bounded latency reservoir; running totals carry the full-run
        # aggregates.
        self._lat: deque = deque(maxlen=65536)
        self._agg = self._fresh_agg()
        self.warm_all()

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
            as_numpy=True,
        )

    def _graph_forward(self, batches):
        return self._forward(batches[0])

    def warm_all(self) -> None:
        """Run one forward per budget shape (building the kernel library
        on the first), then on a card capture it, so no shape is first
        seen under traffic. A capture that fails raises."""
        for b in self.budgets:
            key = _spec_key(b)
            if key in self._warm:
                continue
            t0 = time.perf_counter()
            host = [self.collate_bin([self._example], b)]
            if self.graphs is None:
                self._forward(host[0].to(self.device))
            else:
                self.graphs.eager(self._graph_forward, host)
                self.graphs.capture(key, self._graph_forward, host)
            self._sync()
            self._warm[key] = True
            self.warmup_ms[key] = round(1e3 * (time.perf_counter() - t0), 3)

    # -- the dispatch loop (the serving hot path) ----------------------

    def _dispatch(self, batcher: DynamicBatcher, reason: str, b) -> dict:
        """Collate + H2D + launch ONE bin; returns the in-flight record
        ``_resolve`` completes. No host sync here."""
        if self._closed:
            raise RuntimeError(
                "ServingEngine is closed — a closed engine must never "
                "dispatch"
            )
        reqs = batcher.bin_requests(b)
        spec = batcher.bin_spec(b)
        key = _spec_key(spec)
        if key not in self._warm:
            raise RuntimeError(
                f"no warm shape {key} for the dispatched bin — the "
                "batcher's budget set must equal the engine's; warm "
                f"shapes: {sorted(self._warm)}"
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
            outs = self._forward(batch.to(self.device))
        else:
            outs = tuple(o.clone() for o in self.graphs.replay(key, [batch]))
        t1 = time.perf_counter()
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
        """Per-request slices of the padded head outputs: graph heads
        index the request's graph slot, node heads its node rows."""
        levels = [(h.type, h.dim) for h in self.cfg.heads]
        for gi, req in enumerate(rec["reqs"]):
            off, n = rec["offsets"][gi]
            result = []
            for hi, (level, dim) in enumerate(levels):
                out = outs_host[hi][..., :dim]
                result.append(out[gi] if level == "graph" else out[off : off + n])
            req.result = result

    def _resolve(self, rec: dict) -> dict:
        """Fetch one in-flight bin's outputs and complete its requests —
        the one host sync of the loop."""
        t0 = time.perf_counter()
        outs_host = [o.cpu().numpy() for o in rec["outs"]]
        t_done = rec["clock"]()
        fetch_ms = 1e3 * (time.perf_counter() - t0)
        self._split_outputs(outs_host, rec)
        for req in rec["reqs"]:
            req.t_done = t_done
            req.latency_ms = round(1e3 * (t_done - req.t_enqueue), 4)
        done = dict(rec)
        done["t_done"] = t_done
        done["fetch_ms"] = fetch_ms
        done.pop("outs")  # device tensors are never retained past the fetch
        spec = rec["spec"]
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
        self, batcher: DynamicBatcher, *, timeout: float = 0.2
    ) -> List[dict]:
        """Drive the dispatch loop: pull bins from the batcher, dispatch
        double-buffered, resolve responses. Returns the resolved bin
        records. Exits when the batcher is closed and drained; an idle
        wait of ``timeout`` resolves a pending bin, so a lone request
        never waits for a successor."""
        pending: Optional[dict] = None
        done: List[dict] = []
        while True:
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

    def close(self) -> None:
        """Tear down: forget the warm shapes; any later dispatch raises.
        Idempotent; aggregates survive."""
        self._closed = True
        self._warm = {}
        self.graphs = None

    # -- reporting -----------------------------------------------------

    def rollup(self) -> dict:
        """Aggregate the run: p50/p99 request latency (over the recent
        latency reservoir), graphs/s over the busy window, per-dimension
        fill and slot waste."""
        agg = self._agg
        lat = np.asarray(self._lat, dtype=np.float64)
        row = {
            "requests": int(agg["requests"]),
            "graphs": int(agg["graphs"]),
            "dispatches": int(agg["dispatches"]),
            "shapes": len(self._warm),
        }
        if lat.size:
            row["p50_ms"] = float(np.percentile(lat, 50))
            row["p99_ms"] = float(np.percentile(lat, 99))
            row["max_ms"] = float(lat.max())
            row["mean_ms"] = float(lat.mean())
        if agg["dispatches"]:
            busy = agg["t_last"] - agg["t_first"]
            if busy > 0:
                row["graphs_per_sec"] = agg["graphs"] / busy
            exe_n, exe_e = agg["exe_nodes"], agg["exe_edges"]
            real_n, real_e = agg["real_nodes"], agg["real_edges"]
            row["node_fill"] = real_n / max(exe_n, 1)
            row["edge_fill"] = real_e / max(exe_e, 1)
            row["slot_waste"] = 1.0 - (real_n + real_e) / max(exe_n + exe_e, 1)
            row["dispatch_reasons"] = dict(agg["reasons"])
        return row
