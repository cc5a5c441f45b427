"""Fleet serving tier: N replicated ``ServingEngine``s behind the
routing front.

Counterpart of ``hydragnn_tpu/serve/fleet.py``: ``FleetSettings``,
``fleet_settings``, ``ReplicaHandle`` and ``ServingTier``. The replicas
are threads of one process that share one device, as in the JAX package
(a multi-host deployment runs one tier process per host behind an
external balancer). Each has its own ``DynamicBatcher``, its own
dispatch-loop pump, its own engine (its own copy of the module, with one
captured graph per budget on a card) and, with ``telemetry_base``, its
own telemetry shard with heartbeats, all behind one ``Router``
(``serve/router.py``: least-loaded / spec-affinity dispatch,
deadline-class load shedding). ``device=None`` means ``"cuda"``.

**Zero-downtime rollover** (``rollover``): ADMIT the new snapshot (one
``nonfinite_leaves`` scan for the whole tier), WARM one shadow engine per
replica off the serving path (on a card each shadow captures its graphs
while the old engines keep serving: ``train/capture.GRAPH_LOCK`` holds
their replays and fetches back during a capture), SWAP the router target atomically
per replica, DRAIN the old generation to zero in flight, then tear it
down. Any failure before SWAP leaves every replica serving the old
snapshot untouched: the router cannot reach a half-warmed engine,
because the swap is the first moment the new generation is reachable,
and each engine serves its own module, so a refused shadow changes no
weight of the old one.

**Failure containment**: every replica keeps an in-memory beat (for the
tier's health monitor) and a telemetry heartbeat row stream (for
``tools/graftboard.py fleet``'s dead-replica detection). A replica whose
beat goes quiet past ``heartbeat_timeout_s``, or whose pump thread died,
is declared dead; its unfinished requests are recovered and re-routed to
live replicas (``Router.reroute``), already-expired classes shed loudly.

``kill_replica`` is the drill hook: a kill analog that stops the pump
mid-flight and silences both heartbeat channels without a close row.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from hydragnn_tpu_torch.data.graph import GraphSample, PackSpec
from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.serve.admission import admit_state
from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
from hydragnn_tpu_torch.serve.engine import ServingEngine, ServingSettings
from hydragnn_tpu_torch.serve.router import ROUTER_POLICIES, Router
from hydragnn_tpu_torch.utils import telemetry
from hydragnn_tpu_torch.utils.telemetry import TelemetryStream


@dataclass(frozen=True)
class FleetSettings:
    """Resolved ``Serving.Fleet`` config block (validated by
    ``config.update_config``).

    ``replicas``/``policy``/``queue_bound`` shape the router;
    ``heartbeat_interval_s``/``heartbeat_timeout_s`` drive both the
    in-memory health monitor and the per-replica telemetry heartbeat
    rows; ``class_budgets_ms`` maps deadline class -> end-to-end
    latency budget (None = best-effort) for the expired-shed policy on
    re-route."""

    replicas: int = 2
    policy: str = "least_loaded"
    queue_bound: int = 64
    heartbeat_interval_s: float = 0.25
    heartbeat_timeout_s: float = 1.5
    class_budgets_ms: Tuple[Optional[float], ...] = (None, None, None)


def fleet_settings(config: dict) -> FleetSettings:
    """Resolve ``Serving.Fleet`` (absent -> defaults). Unknown keys are
    rejected by ``config.update_config``."""
    serving = config.get("Serving") or {}
    if isinstance(serving, bool):
        serving = {}
    raw = serving.get("Fleet") or {}
    if not isinstance(raw, dict):
        raise ValueError(
            "Serving.Fleet must be an object "
            '{"replicas", "policy", "queue_bound", '
            '"heartbeat_interval_s", "heartbeat_timeout_s", '
            '"class_budgets_ms"}'
        )
    policy = str(raw.get("policy", "least_loaded"))
    if policy not in ROUTER_POLICIES:
        raise ValueError(
            f"Serving.Fleet.policy {policy!r} unknown; choose from "
            f"{ROUTER_POLICIES}"
        )
    cb = raw.get("class_budgets_ms")
    if cb is None:
        budgets: Tuple[Optional[float], ...] = (None, None, None)
    else:
        budgets = tuple(
            None if v is None else float(v) for v in cb
        )
    return FleetSettings(
        replicas=max(1, int(raw.get("replicas", 2))),
        policy=policy,
        queue_bound=max(1, int(raw.get("queue_bound", 64))),
        heartbeat_interval_s=max(
            0.0, float(raw.get("heartbeat_interval_s", 0.25))
        ),
        heartbeat_timeout_s=max(
            0.05, float(raw.get("heartbeat_timeout_s", 1.5))
        ),
        class_budgets_ms=budgets,
    )


class ReplicaHandle:
    """One engine replica: engine + batcher (the live generation), the
    pump thread driving the dispatch loop, the in-memory beat thread,
    an optional per-replica telemetry shard, and the outstanding-
    request registry the re-route recovers from. Implements the
    Router's replica protocol (``serve/router.py``)."""

    def __init__(
        self,
        index: int,
        *,
        clock=time.monotonic,
        beat_interval_s: float = 0.25,
    ):
        self.index = int(index)
        self.clock = clock
        self.beat_interval_s = max(0.0, float(beat_interval_s))
        self.stream: Optional[TelemetryStream] = None
        self.engine: Optional[ServingEngine] = None
        self.batcher: Optional[DynamicBatcher] = None
        self._lock = threading.Lock()
        self._outstanding: Dict[int, object] = {}
        # Generations for the pump: rollover stages (engine, batcher)
        # pairs here; the pump serves them strictly in order, draining
        # each to zero in-flight before the next.
        self._gens: "queue.Queue" = queue.Queue()
        self.alive = True
        self.killed = False
        self.t_dead: Optional[float] = None
        self._shutdown = False
        self.last_beat = clock()
        self._pump: Optional[threading.Thread] = None
        self._beat: Optional[threading.Thread] = None
        self._beat_stop = threading.Event()

    def start(
        self, engine: ServingEngine, batcher: DynamicBatcher
    ) -> None:
        with self._lock:
            self.engine = engine
            self.batcher = batcher
        self._gens.put_nowait((engine, batcher))
        self._pump = threading.Thread(
            target=self._pump_main,
            name=f"serve-replica-{self.index}",
            daemon=True,
        )
        self._pump.start()
        if self.beat_interval_s > 0:
            self._beat = threading.Thread(
                target=self._beat_main,
                name=f"serve-replica-{self.index}-beat",
                daemon=True,
            )
            self._beat.start()

    # -- router protocol -----------------------------------------------

    # The router-facing gauges snapshot the live batcher UNDER the
    # swap lock, then read the gauge off the snapshot: a concurrent
    # rollover can retire the generation mid-read, but the local
    # reference keeps the retired batcher's gauges coherent — the
    # router sees a slightly stale depth, never a torn object.

    @property
    def deadline_s(self) -> float:
        with self._lock:
            b = self.batcher
        return b.deadline_s

    def qsize(self) -> int:
        with self._lock:
            b = self.batcher
        return b.qsize()

    def oldest_anchor_age_s(self) -> float:
        with self._lock:
            b = self.batcher
        return b.oldest_anchor_age_s()

    def submit_inner(self, sample: GraphSample, deadline_class: int):
        """One atomic batcher put — the SAME lock the rollover swap
        holds, so a request lands wholly in one generation or the
        other, never in a just-closed old batcher."""
        with self._lock:
            return self.batcher.submit(
                sample, deadline_class=deadline_class
            )

    def track(self, fr) -> None:
        with self._lock:
            self._outstanding[fr.fleet_id] = fr
            # Bounded retention: a long-lived replica prunes resolved
            # handles instead of holding every sample+response forever.
            if len(self._outstanding) > 8192:
                for k in [
                    k
                    for k, v in self._outstanding.items()
                    if v.done
                ]:
                    del self._outstanding[k]

    def recover_pending(self) -> List:
        """Unfinished requests, for re-route after death. Single-
        consumer safe only once the pump thread has exited — the
        health monitor joins it before calling this."""
        with self._lock:
            out = [
                fr
                for fr in self._outstanding.values()
                if not fr.done
            ]
            self._outstanding.clear()
        return out

    # -- rollover ------------------------------------------------------

    def swap(
        self, new_engine: ServingEngine, new_batcher: DynamicBatcher
    ) -> ServingEngine:
        """Atomic rollover swap: flip the router target to the warmed
        new generation and close the OLD batcher in the same critical
        section ``submit_inner`` uses. The pump notices the close,
        drains the old generation to zero in-flight, tears it down,
        then picks the new generation off the staging queue. Returns
        the old engine so the caller can await its drain."""
        with self._lock:
            old_engine, old_batcher = self.engine, self.batcher
            self.engine = new_engine
            self.batcher = new_batcher
            self._gens.put_nowait((new_engine, new_batcher))
            old_batcher.close()
        return old_engine

    # -- lifecycle -----------------------------------------------------

    def pump_alive(self) -> bool:
        return self._pump is not None and self._pump.is_alive()

    def kill(self) -> None:
        """Kill analog (drill hook): the pump abandons its loop
        mid-flight, beats stop, and the telemetry shard is abandoned —
        no close row, the signature a killed process leaves for
        graftboard's dead-replica detection. Detection and re-route stay
        the health monitor's job."""
        self.killed = True
        self._beat_stop.set()
        if self.stream is not None:
            self.stream.abandon()

    def shutdown(self, *, timeout_s: float = 60.0) -> None:
        """Graceful teardown: close the live batcher, let the pump
        drain to zero in-flight, emit the final rollup, close engine
        and telemetry shard (WITH its close row). Idempotent."""
        self._shutdown = True
        with self._lock:
            b = self.batcher
        if b is not None:
            b.close()
        if self._pump is not None:
            self._pump.join(timeout=timeout_s)
        self._beat_stop.set()
        if self._beat is not None:
            self._beat.join(timeout=5.0)
        # Snapshot the live engine under the swap lock (a rollover
        # racing this shutdown could flip it mid-teardown); the pump
        # has been joined, so the snapshot is the final generation.
        with self._lock:
            eng = self.engine
        if eng is not None and not eng.closed:
            eng.rollup(emit=True)
            eng.close()
        if self.stream is not None:
            self.stream.close()
        self.alive = False

    # -- worker threads ------------------------------------------------

    def _pump_main(self) -> None:
        while True:
            try:
                engine, batcher = self._gens.get(timeout=0.1)
            except queue.Empty:
                if self.killed or self._shutdown:
                    return
                continue
            engine.process(
                batcher, timeout=0.05, stop=lambda: self.killed
            )
            if self.killed:
                return  # abandoned mid-flight: the kill analog
            with self._lock:
                superseded = engine is not self.engine
            if superseded:
                # Old generation drained to ZERO in-flight (process
                # only returns once a closed batcher is empty) — the
                # rollover teardown.
                engine.rollup(emit=True)
                engine.close()
            elif self._shutdown:
                return

    def _beat_main(self) -> None:
        while not self._beat_stop.wait(self.beat_interval_s):
            if self.killed:
                return
            self.last_beat = self.clock()


class ServingTier:
    """N replicated engines behind the router (module docstring).

    ``state`` is the ``state_dict`` to serve (None: the model's own
    weights); every engine serves its own copy of ``model`` with it.
    ``telemetry_base`` (a ``telemetry.jsonl`` path) arms per-replica
    shards: replica i writes ``shard_path(base, i)`` with heartbeat
    rows, so ``graftboard fleet <dir>`` renders the serving section,
    per-replica p99 skew and dead-replica verdicts. Without it, serve
    rows go to the process's active stream.

    Every construction site tears down in a ``finally`` via ``close()``:
    the tier owns threads and telemetry shards."""

    def __init__(
        self,
        model,
        cfg,
        state,
        budgets: List[PackSpec],
        *,
        example: GraphSample,
        settings: Optional[ServingSettings] = None,
        fleet: Optional[FleetSettings] = None,
        ensure_fields: Optional[dict] = None,
        with_forces: bool = False,
        telemetry_base: Optional[str] = None,
        clock=time.monotonic,
        monitor: bool = True,
        device=None,
    ):
        self.device = resolve_device(device)
        self.settings = settings or ServingSettings(enabled=True)
        self.fleet = fleet or FleetSettings()
        self._model = model
        self._cfg = cfg
        self.budgets = list(budgets)
        self._example = example
        self._ensure_fields = ensure_fields
        self._with_forces = bool(with_forces)
        self._telemetry_base = telemetry_base
        self.clock = clock
        self._closed = False
        self.rollovers = 0
        # ONE admission gate per snapshot for the whole tier; the
        # per-engine gates below are off (the refusal is the same).
        if self.settings.validate_snapshot:
            admit_state(
                model.state_dict() if state is None else state,
                source="serving snapshot",
            )
        self._engine_settings = dataclasses.replace(
            self.settings, validate_snapshot=False
        )
        self.replicas: List[ReplicaHandle] = []
        try:
            for i in range(self.fleet.replicas):
                self.replicas.append(self._spawn_replica(i, state))
        except Exception:
            # A half-built tier must not leak replica threads/shards.
            for h in self.replicas:
                h.shutdown(timeout_s=5.0)
            raise
        self.router = Router(
            self.replicas,
            self.budgets,
            policy=self.fleet.policy,
            queue_bound=self.fleet.queue_bound,
            class_budgets_ms=self.fleet.class_budgets_ms,
            clock=clock,
            emit=self._emit,
        )
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        if monitor:
            self._monitor = threading.Thread(
                target=self._monitor_main,
                name="serve-tier-monitor",
                daemon=True,
            )
            self._monitor.start()

    # -- construction --------------------------------------------------

    def _spawn_replica(self, index: int, state) -> ReplicaHandle:
        h = ReplicaHandle(
            index,
            clock=self.clock,
            beat_interval_s=self.fleet.heartbeat_interval_s,
        )
        if self._telemetry_base:
            h.stream = TelemetryStream(
                telemetry.shard_path(self._telemetry_base, index),
                process_index=index,
                heartbeat_interval_s=self.fleet.heartbeat_interval_s,
                meta={"role": "serve_replica", "replica": index},
            )
        h.start(self._build_engine(state, h), self._make_batcher())
        return h

    def _build_engine(self, state, h: ReplicaHandle) -> ServingEngine:
        return ServingEngine(
            self._model,
            self._cfg,
            state,
            self.budgets,
            example=self._example,
            settings=self._engine_settings,
            ensure_fields=self._ensure_fields,
            with_forces=self._with_forces,
            stream=h.stream,
            replica=h.index,
            device=self.device,
        )

    def _make_batcher(self) -> DynamicBatcher:
        return DynamicBatcher(
            self.budgets,
            deadline_ms=self.settings.deadline_ms,
            max_open_bins=self.settings.max_open_bins,
            clock=self.clock,
        )

    def _emit(self, row: dict) -> None:
        """Router/tier rows (shed, reroute, rollover) land on the
        first LIVE replica's shard (the routing front has no shard of
        its own), or the process-global stream without shards."""
        for h in self.replicas:
            if h.alive and h.stream is not None:
                h.stream.emit(row)
                return
        telemetry.emit(row)

    # -- the request front ---------------------------------------------

    def submit(
        self, sample: GraphSample, *, deadline_class: int = 1
    ):
        """Route one request through the fleet (never blocks); returns
        its ``FleetRequest`` handle — served, or loudly ``shed``."""
        if self._closed:
            raise RuntimeError(
                "ServingTier is closed — no further submits"
            )
        return self.router.submit(
            sample, deadline_class=deadline_class
        )

    # -- health --------------------------------------------------------

    def check_health(self) -> List[int]:
        """One health sweep (the monitor thread's body; tests and
        drills may call it directly): a live replica whose in-memory
        beat trails the clock past ``heartbeat_timeout_s`` — or whose
        pump thread died — is declared DEAD, its pump joined (the
        dispatch loop must have exited before recovery touches
        batcher state), and its unfinished requests re-routed.
        Returns the newly-dead replica indices."""
        now = self.clock()
        newly: List[int] = []
        for h in self.replicas:
            if not h.alive:
                continue
            gap = now - h.last_beat
            if not (
                h.killed
                or not h.pump_alive()
                or gap > self.fleet.heartbeat_timeout_s
            ):
                continue
            h.alive = False
            h.t_dead = now
            if h._pump is not None:
                h._pump.join(timeout=10.0)
            self.router.reroute(h)
            newly.append(h.index)
        return newly

    def _monitor_main(self) -> None:
        interval = max(self.fleet.heartbeat_interval_s, 0.05)
        while not self._monitor_stop.wait(interval):
            try:
                self.check_health()
            except Exception as e:
                # The monitor surviving is non-negotiable (a crashed
                # monitor is silent loss of dead-replica detection) —
                # but its failures are not: they go on the stream.
                self._emit(
                    {
                        "t": "tier_monitor_error",
                        "error": repr(e)[:200],
                    }
                )

    def kill_replica(self, index: int) -> None:
        """DRILL HOOK — murder replica ``index`` (kill analog; see
        ``ReplicaHandle.kill``). Detection and re-route remain the
        health monitor's job: this only kills."""
        self.replicas[index].kill()

    # -- rollover ------------------------------------------------------

    def rollover(
        self,
        state,
        *,
        source: str = "rollover snapshot",
        drain_timeout_s: float = 60.0,
    ) -> dict:
        """Zero-downtime snapshot swap (module docstring): ADMIT →
        WARM → SWAP → DRAIN → TEARDOWN. ``state`` is a ``state_dict``.
        Raises (AdmissionError on a non-finite snapshot, whatever the
        warm-up raised otherwise) with every replica still serving the
        OLD snapshot when any step before SWAP fails — the refusal
        leaves no trace but a ``rollover: refused`` telemetry row
        (shadows already warmed are closed). Returns the rollover
        accounting row."""
        if self._closed:
            raise RuntimeError("ServingTier is closed")
        t0 = time.perf_counter()
        shadows = []
        try:
            # ADMIT: one scan for the tier, same gate as startup.
            if self.settings.validate_snapshot:
                admit_state(state, source=source)
            # WARM: shadow engines warm (and capture) the full budget set
            # off the serving path; the router cannot see them yet.
            for h in self.replicas:
                if h.alive:
                    shadows.append((h, self._build_engine(state, h)))
        except Exception as e:
            for _, eng in shadows:
                eng.close()
            self._emit(
                {
                    "t": "rollover",
                    "phase": "refused",
                    "error": repr(e)[:200],
                }
            )
            raise
        warm_ms = round(1e3 * (time.perf_counter() - t0), 1)
        # SWAP: per replica, atomic against the submit path.
        olds = []
        for h, eng in shadows:
            if not h.alive:
                # Died during warm-up: its shadow dies with it — the
                # router never pointed at the half-served replica.
                eng.close()
                continue
            olds.append((h, h.swap(eng, self._make_batcher())))
        # DRAIN: old generations to zero in-flight (the pump tears
        # each down after its drain; we only await the confirmations).
        deadline = time.monotonic() + max(drain_timeout_s, 0.1)
        undrained = []
        for h, old in olds:
            while not old.closed and time.monotonic() < deadline:
                time.sleep(0.01)
            if not old.closed:
                undrained.append(h.index)
        self.rollovers += 1
        row = {
            "t": "rollover",
            "phase": "done",
            "replicas": [h.index for h, _ in olds],
            "warm_ms": warm_ms,
            "drained": not undrained,
            "undrained": undrained,
            "total_ms": round(1e3 * (time.perf_counter() - t0), 1),
        }
        self._emit(row)
        return row

    # -- reporting / teardown ------------------------------------------

    def report(self) -> dict:
        """Per-replica rollups + router shed accounting — the fleet
        bench/drill gate surface."""
        per: Dict[str, dict] = {}
        for h in self.replicas:
            per[str(h.index)] = {
                "alive": h.alive,
                "killed": h.killed,
                "queue_depth": h.qsize() if h.alive else None,
                "rollup": (
                    h.engine.rollup(emit=False)
                    if h.engine is not None
                    else None
                ),
            }
        return {
            "policy": self.fleet.policy,
            "replicas": per,
            "router": self.router.shed_report(),
            "rollovers": self.rollovers,
        }

    def close(self, *, timeout_s: float = 60.0) -> None:
        """Graceful tier teardown: monitor first (it must not declare
        shutting-down replicas dead), then each replica drains to
        zero in-flight, final rollups and close rows land on the
        shards. Killed replicas are skipped — their abandonment IS
        their record. Idempotent; every bench/drill path calls this
        in a ``finally``."""
        if self._closed:
            return
        self._closed = True
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        for h in self.replicas:
            if h.killed:
                h.alive = False
                continue
            h.shutdown(timeout_s=timeout_s)
