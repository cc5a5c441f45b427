"""Run telemetry: JSONL streams, the step clock, live MFU, counted
executables and the compile observer.

Counterpart of ``hydragnn_tpu/utils/telemetry.py``, with its row and
field names (docs/OBSERVABILITY.md), so that ``tools/graftboard.py``
reads the port's streams unchanged. One discipline holds throughout:
telemetry never blocks or perturbs a step, and a run with it on equals
the run with it off bit for bit.

- ``TelemetryStream``: a bounded, non-blocking JSONL writer. ``emit`` is
  a ``put_nowait``; a full queue drops the row and counts it; a daemon
  worker batches rows into one write + flush and absorbs I/O failures
  onto ``write_errors``/``last_error``. A ``header`` row opens the
  stream (host, device and peak facts), a ``close`` accounting row ends
  a clean one; ``abandon`` stops it as a killed process leaves its
  shard. Process ``i`` of a run writes ``shard_path(base, i)``.
- A heartbeat thread per stream emits ``heartbeat`` rows carrying the
  run phase (``note_phase``), the blocking coordination wait in flight
  (``waiting_on``) and the liveness counters (``bump``); coordination
  waits are ``barrier`` rows (``emit_barrier``).
- ``StepClock`` (built per epoch by ``epoch_clock``, driven by
  ``train/loop._run_epoch``): one ``step`` row per dispatch (input wait,
  host dispatch, wall, and with ``sync_interval_steps`` > 0 a sampled
  ``device_complete_ms``), and per (epoch, spec) a ``spec_rollup`` row
  with the live ``mfu`` of ``utils/flops.py``'s analytic inventory over
  the plan's real sizes, against the card's peak. On the card a step is
  a CUDA-graph replay whose outputs the next replay overwrites, so the
  clock copies each dispatch's loss (and graph count) into a per-epoch
  device buffer right after the dispatch, outside any graph, and
  fetches the buffer once at the epoch's end, after the loop's own
  fetch. Nothing per step syncs, and no graph gains a node.
- Counted executables: the first dispatch of each (region, spec, k,
  lanes) runs under ``ExecCounter``, a ``TorchDispatchMode`` over that
  step's first eager run (the graph cache's first sight of the shape,
  ``train/capture.py``), counting flops with ``torch.utils.flop_counter``'s
  formulas and bytes as each aten op's operand and output bytes (views
  excluded); K1 and K2 count as ``ops/edge_pipeline.k1_work``/
  ``k2_work`` say. One ``executable`` row per key, with the static
  buffers' argument and output bytes and, once captured, the graph
  pool as ``temp_bytes``; ``spec_rollup`` gains ``hw_flops``,
  ``hw_mfu``, ``intensity`` and ``hw_over_model_flops``. A counter that
  fails reports ``capture_error`` and is never retried.
- ``CompileObserver``: on the port a compile is a CUDA-graph capture.
  One ``compile`` row per capture (its seconds as ``ms``, the epoch as
  phase); a capture at epoch >= 1 is a ``retrace_leak``; a
  ``compile_summary`` row on close, with the kernel library's build
  cache (``ops/cuda_build.py``) as hits and misses. Its hook, the
  stream's worker and the heartbeat thread make no CUDA call (a CUDA
  call from another thread fails a capture in progress): ``memory`` rows
  come from the loop thread only, at run start, at epoch boundaries and
  after each capture.

Config: ``Training.Telemetry {enabled, stream_path, sync_interval_steps,
rollup, queue_depth, cost_analysis, heartbeat_interval_s}``, with the
``HYDRAGNN_TPU_TELEMETRY`` / ``_STREAM`` / ``_SYNC`` environment
overrides.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from hydragnn_tpu_torch.utils import faults

SCHEMA_VERSION = 1

__all__ = [
    "SCHEMA_VERSION",
    "TelemetrySettings",
    "telemetry_settings",
    "TelemetryStream",
    "StepClock",
    "ExecCounter",
    "CompileObserver",
    "configure",
    "install",
    "get",
    "active",
    "emit",
    "memory_row",
    "emit_memory",
    "set_context",
    "get_context",
    "process_identity",
    "shard_path",
    "note_phase",
    "get_phase",
    "waiting_on",
    "bump",
    "counters",
    "heartbeat_row",
    "emit_barrier",
    "suppress_compile_events",
    "note_epoch",
    "end_of_training",
    "epoch_clock",
    "install_observer",
    "observer",
    "close_run",
]


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class TelemetrySettings:
    enabled: bool = False
    stream_path: Optional[str] = None  # default logs/<log_name>/telemetry.jsonl
    sync_interval_steps: int = 0  # 0 = never fence
    rollup: bool = True  # per-epoch spec_rollup rows
    queue_depth: int = 16384
    cost_analysis: bool = True  # counted executable rows
    heartbeat_interval_s: float = 10.0  # 0 = no heartbeat thread


def telemetry_settings(training: dict) -> TelemetrySettings:
    """The ``Training.Telemetry`` block (and its environment overrides)
    as settings. ``Telemetry: true`` is ``{"enabled": true}``; unknown
    keys were refused by ``config.update_config``."""
    raw = training.get("Telemetry") or {}
    if isinstance(raw, bool):
        raw = {"enabled": raw}
    elif not isinstance(raw, dict):
        raise ValueError(
            "Training.Telemetry must be a bool or an object "
            '{"enabled", "stream_path", "sync_interval_steps", '
            '"rollup", "queue_depth", "cost_analysis", '
            '"heartbeat_interval_s"}'
        )
    enabled = bool(raw.get("enabled", False))
    env = os.environ.get("HYDRAGNN_TPU_TELEMETRY")
    if env is not None:
        enabled = env.strip().lower() not in ("", "0", "false", "no")
    path = os.environ.get("HYDRAGNN_TPU_TELEMETRY_STREAM") or raw.get("stream_path")
    sync_env = os.environ.get("HYDRAGNN_TPU_TELEMETRY_SYNC", "").strip()
    sync = int(sync_env) if sync_env else int(raw.get("sync_interval_steps", 0))
    return TelemetrySettings(
        enabled=enabled,
        stream_path=path,
        sync_interval_steps=max(0, sync),
        rollup=bool(raw.get("rollup", True)),
        queue_depth=max(64, int(raw.get("queue_depth", 16384))),
        cost_analysis=bool(raw.get("cost_analysis", True)),
        heartbeat_interval_s=max(0.0, float(raw.get("heartbeat_interval_s", 10.0))),
    )


def process_identity() -> Tuple[int, int]:
    """``(process_index, process_count)`` for shard naming and row
    tagging: the launcher environment (``HYDRAGNN_TPU_PROCESS_ID`` /
    ``HYDRAGNN_TPU_NUM_PROCESSES``) wins, then an initialized
    ``torch.distributed`` group, else ``(0, 1)``. Constructing a stream
    never initializes a group."""
    idx = cnt = None
    e_idx = os.environ.get("HYDRAGNN_TPU_PROCESS_ID", "").strip()
    e_cnt = os.environ.get("HYDRAGNN_TPU_NUM_PROCESSES", "").strip()
    if e_idx.isdigit():
        idx = int(e_idx)
    if e_cnt.isdigit():
        cnt = int(e_cnt)
    if idx is None or cnt is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            if idx is None:
                idx = int(dist.get_rank())
            if cnt is None:
                cnt = int(dist.get_world_size())
    return (idx or 0, cnt or 1)


def shard_path(base: str, process_index: int) -> str:
    """The shard of process ``process_index`` for ``base``: process 0
    keeps ``base``; process ``i`` gets ``<root>.proc<i><ext>`` next to
    it, so one directory holds one run's whole fleet."""
    if process_index <= 0:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.proc{int(process_index)}{ext}"


# ----------------------------------------------------------------------
# The stream writer
# ----------------------------------------------------------------------


def device_kind_of(device) -> Optional[str]:
    """The name the peak tables key on: ``torch.cuda.get_device_name``
    for a CUDA device, ``"cpu"`` for the CPU, None when unknown."""
    if device is None:
        return None
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _self_description(device=None) -> dict:
    """Host, device and peak facts for the ``header`` row. ``device`` is
    the run's device; without one, device fields appear only when CUDA
    is already initialized (constructing a stream never initializes a
    device)."""
    import torch

    out: Dict[str, Any] = {}
    try:
        import socket

        out["hostname"] = socket.gethostname()
    except OSError:
        pass
    out["torch_version"] = torch.__version__
    if device is None and torch.cuda.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None:
        device = torch.device(device)
        kind = device_kind_of(device)
        cuda = device.type == "cuda"
        out["device_kind"] = kind
        out["platform"] = "gpu" if cuda else device.type
        local = torch.cuda.device_count() if cuda else 1
        _, procs = process_identity()
        out["device_count"] = local * procs
        out["local_device_count"] = local
        out["process_count"] = procs
        from hydragnn_tpu_torch.utils.flops import resolve_peak_bandwidth, resolve_peak_flops

        peak, basis = resolve_peak_flops(kind)
        if peak:
            out["peak_flops"] = peak
            out["peak_basis"] = basis
        bw, bw_basis = resolve_peak_bandwidth(kind)
        if bw:
            out["peak_hbm_bytes_per_sec"] = bw
            out["peak_hbm_basis"] = bw_basis
    return out


def _json_default(x):
    """Serialize numpy scalars and arrays (anything exotic degrades to
    str rather than killing the worker)."""
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError, RuntimeError):
            pass
    tolist = getattr(x, "tolist", None)
    if callable(tolist):
        try:
            return tolist()
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(x)


class TelemetryStream:
    """Bounded non-blocking JSONL writer, one JSON object per line
    (module docstring). ``heartbeat_interval_s`` > 0 starts the
    heartbeat thread; ``process_index`` names the shard's process (the
    replica index in a serving tier); ``meta`` is merged into the
    header; ``device`` is the run's device for the header's device and
    peak fields. ``exec_stats`` maps each counted (region, spec, k,
    lanes) to its ``{"flops", "bytes"}`` (None after a failed count)."""

    def __init__(
        self,
        path: str,
        *,
        queue_depth: int = 16384,
        sync_interval_steps: int = 0,
        rollup: bool = True,
        cost_analysis: bool = True,
        heartbeat_interval_s: float = 0.0,
        process_index: Optional[int] = None,
        meta: Optional[dict] = None,
        device=None,
    ) -> None:
        self.path = path
        self.sync_interval_steps = max(0, int(sync_interval_steps))
        self.rollup = bool(rollup)
        self.cost_analysis = bool(cost_analysis)
        self.heartbeat_interval_s = max(0.0, float(heartbeat_interval_s))
        ident = process_identity()
        self.process_index = int(ident[0] if process_index is None else process_index)
        self.process_count = int(ident[1])
        self.heartbeats = 0
        self.dropped = 0
        self.emitted = 0
        self.written = 0
        self.lost_rows = 0
        self.write_errors = 0
        self.last_error: Optional[BaseException] = None
        self.exec_stats: Dict[Tuple, Optional[dict]] = {}
        self.exec_captured = 0
        self.exec_capture_failures = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=max(64, queue_depth))
        self._stop = threading.Event()
        self._hb_stop = threading.Event()
        self._closed = False
        self._fh = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        header = {"t": "header", "schema": SCHEMA_VERSION, "pid": os.getpid(),
                  "sync_interval_steps": self.sync_interval_steps}
        header.update(_self_description(device))
        self.device_kind = header.get("device_kind")
        header["process_index"] = self.process_index
        header["process_count"] = self.process_count
        if meta:
            header.update(meta)
        self._q.put_nowait(header)
        self.emitted += 1
        self._worker = threading.Thread(
            target=self._worker_main, name="telemetry-stream", daemon=True
        )
        self._worker.start()
        self._hb_thread = None
        if self.heartbeat_interval_s > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_main, name="telemetry-heartbeat", daemon=True
            )
            self._hb_thread.start()

    # -- caller side ---------------------------------------------------

    def emit(self, row: Dict[str, Any]) -> bool:
        """Enqueue one row; False (and ``dropped`` + 1) on overflow or
        after close. Never blocks and never raises."""
        if self._closed:
            return False
        try:
            self._q.put_nowait(row)
        except queue.Full:
            self.dropped += 1
            return False
        self.emitted += 1
        return True

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait (bounded) until every enqueued row has reached the file
        or been counted lost."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._q.empty() and self.written + self.lost_rows >= self.emitted:
                return True
            time.sleep(0.005)
        return False

    def close(self, timeout: float = 30.0) -> None:
        """Emit the final accounting row, drain, and stop the worker.
        Idempotent; never raises on I/O failure."""
        if self._closed:
            return
        # The heartbeat stops first, so the close row stays the last.
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=timeout)
        self.emit(
            {
                "t": "close",
                "emitted": self.emitted + 1,
                "dropped": self.dropped,
                "write_errors": self.write_errors,
                "lost_rows": self.lost_rows,
                "executables": self.exec_captured,
                "exec_capture_failures": self.exec_capture_failures,
            }
        )
        self._closed = True
        self.flush(timeout)
        self._stop.set()
        self._worker.join(timeout=timeout)

    def abandon(self, timeout: float = 5.0) -> None:
        """Stop the stream WITHOUT a close row: heartbeats stop and the
        shard ends as a killed process leaves it (graftboard's
        dead-process signature). Rows already queued still drain."""
        if self._closed:
            return
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=timeout)
        self._closed = True
        self.flush(timeout)
        self._stop.set()
        self._worker.join(timeout=timeout)

    # -- worker side ---------------------------------------------------

    def _worker_main(self) -> None:
        while True:
            rows: List[dict] = []
            try:
                rows.append(self._q.get(timeout=0.05))
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            while len(rows) < 1024:
                try:
                    rows.append(self._q.get_nowait())
                except queue.Empty:
                    break
            lines: List[str] = []
            try:
                for row in rows:
                    try:
                        # Tagged here, on the worker: the caller never
                        # pays the copy.
                        if "process_index" not in row:
                            row = dict(row, process_index=self.process_index)
                        lines.append(
                            json.dumps(row, default=_json_default, separators=(",", ":"))
                        )
                    except Exception as e:  # one bad row never kills a batch
                        self.write_errors += 1
                        self.last_error = e
                        self.lost_rows += 1
                if lines:
                    faults.on_write(self.path)
                    if self._fh is None:
                        self._fh = open(self.path, "a")
                    self._fh.write("\n".join(lines) + "\n")
                    self._fh.flush()
                    self.written += len(lines)
            except Exception as e:
                # A dead filesystem degrades the stream, never the caller;
                # the file re-opens on the next batch.
                self.write_errors += 1
                self.last_error = e
                self.lost_rows += len(lines)
                try:
                    if self._fh is not None:
                        self._fh.close()
                except OSError:
                    pass
                self._fh = None
        try:
            if self._fh is not None:
                self._fh.close()
        except OSError:
            pass
        self._fh = None

    def _heartbeat_main(self) -> None:
        """One ``heartbeat`` row at once (every shard has one), then one
        per interval, on its own thread: a stalled caller never silences
        it."""
        while not self._hb_stop.is_set() and not self._closed:
            self.heartbeats += 1
            self.emit(heartbeat_row(self.heartbeats, self.heartbeat_interval_s))
            if self._hb_stop.wait(self.heartbeat_interval_s):
                break


# ----------------------------------------------------------------------
# The process's active stream and run context
# ----------------------------------------------------------------------

_ACTIVE: Optional[TelemetryStream] = None
_CONTEXT: Dict[str, Any] = {}


def install(stream: Optional[TelemetryStream]) -> None:
    """Install ``stream`` as the process's active stream. A new stream
    starts a new run's ledger: the counters and the phase reset.
    ``install(None)`` only detaches."""
    global _ACTIVE
    if stream is not None:
        _COUNTERS.clear()
        note_phase("startup")
    _ACTIVE = stream


def get() -> Optional[TelemetryStream]:
    return _ACTIVE


def active() -> bool:
    return _ACTIVE is not None


def emit(row: Dict[str, Any]) -> bool:
    """Emit onto the active stream; a no-op (one global read) when none
    is installed."""
    s = _ACTIVE
    if s is None:
        return False
    return s.emit(row)


def memory_row(tag: str, epoch: Optional[int] = None) -> Dict[str, Any]:
    """One ``memory`` row: the cards' allocator counters (summed and
    max'd over the process's cards, ``utils/runtime.memory_stats``) and
    the host RSS. Without CUDA (the CPU) only the host fields. Reads the
    allocator, so it is called from the loop thread only, outside any
    capture."""
    from hydragnn_tpu_torch.utils.runtime import host_memory, memory_stats

    row: Dict[str, Any] = {"t": "memory", "tag": tag}
    if epoch is not None:
        row["epoch"] = int(epoch)
    dev = memory_stats()
    if dev:
        row["devices"] = len(dev)
        in_use = [v["bytes_in_use"] for v in dev.values()]
        peak = [v["peak_bytes_in_use"] for v in dev.values()]
        row["bytes_in_use"] = int(sum(in_use))
        row["max_bytes_in_use"] = int(max(in_use))
        row["peak_bytes_in_use"] = int(sum(peak))
        row["max_peak_bytes_in_use"] = int(max(peak))
        row["bytes_limit"] = int(sum(v["bytes_limit"] for v in dev.values()))
    row.update(host_memory())
    return row


def emit_memory(tag: str, epoch: Optional[int] = None) -> bool:
    """Sample and emit a ``memory`` row onto the active stream (no
    sample is taken with the stream off)."""
    s = _ACTIVE
    if s is None:
        return False
    return s.emit(memory_row(tag, epoch))


def set_context(**kw) -> None:
    """Run context the step clock folds into its rows: ``model_cfg``
    (models/spec.ModelConfig, for the MFU rows), ``scheme``, ``lr``,
    ``epoch``. The runner sets it; tests may too."""
    _CONTEXT.update(kw)


def get_context() -> Dict[str, Any]:
    return dict(_CONTEXT)


# ----------------------------------------------------------------------
# Liveness: run phase, blocking-wait site, counters, barrier rows
# ----------------------------------------------------------------------

_PHASE = "startup"
_PHASE_TS = time.time()
# Blocking waits in flight, per thread (the checkpoint worker and the
# loop may wait at once).
_WAIT_SITES: Dict[int, Tuple[str, float]] = {}
_COUNTERS: Dict[str, int] = {}


def note_phase(name: str) -> None:
    """Advance the coarse run phase the heartbeat rows carry."""
    global _PHASE, _PHASE_TS
    _PHASE = str(name)
    _PHASE_TS = time.time()


def get_phase() -> str:
    return _PHASE


@contextlib.contextmanager
def waiting_on(site: str):
    """Mark a blocking coordination wait (a cross-rank barrier, a
    broadcast) for the enclosed call: heartbeats meanwhile carry
    ``waiting_on``/``wait_age_s``. Per thread; nested waits restore the
    outer site on exit."""
    key = threading.get_ident()
    prev = _WAIT_SITES.get(key)
    _WAIT_SITES[key] = (str(site), time.time())
    try:
        yield
    finally:
        if prev is None:
            _WAIT_SITES.pop(key, None)
        else:
            _WAIT_SITES[key] = prev


def bump(name: str, n: int = 1) -> None:
    """Count feed/dispatch liveness for the heartbeat rows (a frozen
    counter across beats is a wedged feed). A no-op with the stream
    off."""
    if _ACTIVE is None:
        return
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_COUNTERS)


def heartbeat_row(seq: int, interval_s: float) -> Dict[str, Any]:
    """One liveness row: wall clock, run phase (and its age), the
    oldest blocking wait in flight, and the counter snapshot. Host reads
    only: built on the heartbeat thread."""
    now = time.time()
    row: Dict[str, Any] = {
        "t": "heartbeat",
        "seq": int(seq),
        "ts": round(now, 3),
        "interval_s": interval_s,
        "phase": _PHASE,
        "phase_age_s": round(now - _PHASE_TS, 3),
    }
    try:
        # Snapshots of dicts other threads mutate can rarely raise
        # mid-resize; a beat without the optional fields beats none.
        sites = list(_WAIT_SITES.values())
        if sites:
            site, ts0 = min(sites, key=lambda sv: sv[1])
            row["waiting_on"] = site
            row["wait_age_s"] = round(now - ts0, 3)
        if _COUNTERS:
            row["counters"] = dict(_COUNTERS)
    except RuntimeError:
        pass
    return row


def emit_barrier(
    site: str,
    seq: int,
    total_s: float,
    barrier_s: Optional[float] = None,
    timed_out: bool = False,
    broadcast: bool = False,
) -> bool:
    """One ``barrier`` row for a coordination wait: ``wait_ms`` the
    whole crossing, ``barrier_ms`` only the time parked at the
    rendezvous (the last arriver barely parks: graftboard fleet's
    attribution signal). ``timed_out`` marks a wait that raised;
    ``broadcast`` an asymmetric wait (a broadcast from rank 0) that
    graftboard reports but never attributes. A no-op with the stream
    off."""
    s = _ACTIVE
    if s is None:
        return False
    row: Dict[str, Any] = {
        "t": "barrier",
        "site": str(site),
        "seq": int(seq),
        "ts": round(time.time(), 3),
        "wait_ms": round(1e3 * float(total_s), 3),
    }
    if barrier_s is not None:
        row["barrier_ms"] = round(1e3 * float(barrier_s), 3)
    if timed_out:
        row["timed_out"] = True
    if broadcast:
        row["broadcast"] = True
    ep = _CONTEXT.get("epoch")
    if ep is not None:
        row["epoch"] = int(ep)
    bump("barriers")
    return s.emit(row)


def note_epoch(epoch: int, lr: Optional[float] = None) -> None:
    """Advance the run context (and the compile observer's phase) to
    ``epoch``, so a capture is attributed to the epoch that caused it."""
    _CONTEXT["epoch"] = int(epoch)
    if lr is not None:
        _CONTEXT["lr"] = float(lr)
    obs = _OBSERVER
    if obs is not None:
        obs.set_phase(int(epoch))


def end_of_training() -> None:
    """Mark the post-training phase: captures from here on (the
    recalibration, the test pass) are new graphs by design, not leaks."""
    note_phase("post_training")
    obs = _OBSERVER
    if obs is not None:
        obs.set_phase(-1)


def configure(
    training: dict,
    log_name: Optional[str] = None,
    meta: Optional[dict] = None,
    device=None,
) -> Optional[TelemetryStream]:
    """Build and install the stream and the compile observer from the
    ``Training.Telemetry`` block; None when disabled. Every process of a
    multi-rank run configures its own shard (``shard_path``). ``device``
    is the run's device: on a card the header names it and its peaks."""
    st = telemetry_settings(training)
    if not st.enabled:
        return None
    base = st.stream_path or os.path.join("logs", log_name or "run", "telemetry.jsonl")
    # Reset the run ledger before the heartbeat's first beat.
    _COUNTERS.clear()
    note_phase("startup")
    _CONTEXT.clear()
    pidx, _ = process_identity()
    stream = TelemetryStream(
        shard_path(base, pidx),
        queue_depth=st.queue_depth,
        sync_interval_steps=st.sync_interval_steps,
        rollup=st.rollup,
        cost_analysis=st.cost_analysis,
        heartbeat_interval_s=st.heartbeat_interval_s,
        meta=meta,
        device=device,
    )
    install(stream)
    install_observer(stream)
    return stream


def close_run(stream: Optional[TelemetryStream]) -> None:
    """Tear down what ``configure`` built: the observer (its summary
    row lands first), then the stream. Only the module state this stream
    owns is touched."""
    if stream is None:
        return
    obs = _OBSERVER
    if obs is not None and obs.stream is stream:
        obs.close()
    stream.close()
    global _ACTIVE
    if _ACTIVE is stream:
        _ACTIVE = None


# ----------------------------------------------------------------------
# Counted executables
# ----------------------------------------------------------------------


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


class ExecCounter:
    """Counts one step's work over its first eager run (module
    docstring): ``run(fn, batches)`` calls ``fn(batches)`` under a
    ``TorchDispatchMode`` and returns its outputs untouched. ``flops``
    sums ``torch.utils.flop_counter``'s formulas over the aten ops that
    have one, and K1/K2's ``ops/edge_pipeline.kernel_work``; ``bytes``
    sums each op's tensor operand and output bytes (views excluded; K1
    and K2 as ``kernel_work`` counts them). ``kernels`` keeps K1's and
    K2's calls, flops and bytes, and their plan sizes, apart.
    ``argument_bytes``/``output_bytes`` are the batches' and outputs'
    bytes. ``graphs``/``graph_key`` name the graph cache entry whose
    capture gives ``temp_bytes``."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, dict] = {}
        self.ran = False
        self.error: Optional[str] = None
        self.argument_bytes = 0
        self.output_bytes = 0
        self.seconds = 0.0
        self.graphs = None
        self.graph_key = None

    def run(self, fn, batches):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        from hydragnn_tpu_torch.ops.edge_pipeline import kernel_work

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if counter.error is not None:
                    return out
                try:
                    work = kernel_work(func, args)
                    if work is not None:
                        name, nbytes, ops, sizes = work
                        k = counter.kernels.setdefault(
                            name, {"calls": 0, "flops": 0.0, "bytes_accessed": 0.0, **sizes})
                        k["calls"] += 1
                        k["flops"] += ops
                        k["bytes_accessed"] += nbytes
                        counter.flops += ops
                        counter.bytes += nbytes
                        return out
                    formula = flop_registry.get(func.overloadpacket)
                    if formula is not None:
                        counter.flops += float(formula(*args, **kwargs, out_val=out))
                    if not func.is_view:
                        counter.bytes += (_tensor_bytes(list(args))
                                          + _tensor_bytes(list(kwargs.values()))
                                          + _tensor_bytes(out))
                except Exception as e:  # the count fails, never the step
                    counter.error = f"{func}: {e!r}"[:200]
                return out

        t0 = time.perf_counter()
        self.ran = True
        self.argument_bytes = _tensor_bytes(
            [t for b in batches for t in vars(b).values()])
        with _Mode():
            out = fn(batches)
        self.output_bytes = _tensor_bytes(out)
        self.seconds = time.perf_counter() - t0
        return out


# ----------------------------------------------------------------------
# The step clock
# ----------------------------------------------------------------------


def _feed_labels(loader) -> tuple:
    """(feed, scheme_hint, lanes, base loader with ``epoch_size_rows``)
    from the wrapper chain (each wrapper exposes ``.loader``)."""
    labels = []
    d = 1
    base = None
    scheme = None
    ld, depth = loader, 0
    while ld is not None and depth < 8:
        name = type(ld).__name__
        if name == "ParallelPipelineLoader":
            labels.append("pipeline")
        elif name == "PrefetchLoader":
            labels.append("prefetch")
        elif name == "SuperstepLoader":
            labels.append("superstep")
        elif name == "DPLoader":
            labels.append("dp")
            scheme = "dp"
            d = int(getattr(ld, "n", 1))
            if int(getattr(ld, "superstep_k", 1)) > 1:
                labels.append("superstep")
        elif name == "MultiBranchLoader":
            labels.append("multibranch")
            scheme = "multibranch"
        if hasattr(ld, "epoch_size_rows"):
            base = ld
        ld, depth = getattr(ld, "loader", None), depth + 1
    return ("+".join(labels) or "serial", scheme, d, base)


def _spec_of(batch) -> tuple:
    """(spec_id, nodes_pad, edges_pad, graphs_pad) of a host batch's
    padded shapes (no device access)."""
    n = int(batch.node_mask.shape[-1])
    e = int(batch.edge_mask.shape[-1])
    g = int(batch.graph_mask.shape[-1])
    return (f"n{n}_e{e}_g{g}", n, e, g)


class _Probe:
    """One dispatch's hand-off between the clock and the superstep:
    ``counter`` (an ``ExecCounter`` on the key's first dispatch) goes in,
    the raw step outputs ``out`` come back."""

    __slots__ = ("counter", "out")

    def __init__(self, counter=None):
        self.counter = counter
        self.out = None


class StepClock:
    """Per-epoch step clock (module docstring), built by
    ``epoch_clock`` and driven by ``train/loop._run_epoch``: ``probe``
    before each dispatch, ``record`` after it, ``finish`` after the
    epoch's fetch."""

    def __init__(
        self,
        stream: TelemetryStream,
        *,
        region: str,
        epoch: int = 0,
        feed: str = "serial",
        scheme: str = "single",
        d: int = 1,
        step0: int = 0,
        size_rows=None,
        model_cfg=None,
        lr: Optional[float] = None,
    ) -> None:
        self.stream = stream
        self.region = region
        self.epoch = int(epoch)
        self.feed = feed
        self.scheme = scheme
        self.d = max(1, int(d))
        self.lr = lr
        self.model_cfg = model_cfg
        self.sync_interval = stream.sync_interval_steps
        self._rows: List[dict] = []
        self._execs: List[Tuple[dict, ExecCounter]] = []
        self._buf = None  # [capacity, 2] float64 (loss, graphs) per dispatch
        self._n_refs = 0
        self._size_rows = size_rows
        self._size_cursor = int(step0) * self.d
        self._prev_end: Optional[float] = None
        self._n_records = 0

    def probe(self, batch, k: int) -> _Probe:
        """The dispatch's probe: with an ``ExecCounter`` when its key has
        not been counted yet (claimed now: a failed count is never
        retried)."""
        key = (self.region, _spec_of(batch)[0], int(k), self.d)
        if not self.stream.cost_analysis or key in self.stream.exec_stats:
            return _Probe()
        self.stream.exec_stats[key] = None
        return _Probe(ExecCounter())

    def _slot(self, device):
        import torch

        if self._buf is None or self._n_refs >= self._buf.shape[0]:
            cap = 256 if self._buf is None else 2 * self._buf.shape[0]
            buf = torch.zeros((cap, 2), dtype=torch.float64, device=device)
            if self._buf is not None:
                buf[: self._buf.shape[0]].copy_(self._buf)
            self._buf = buf
        i = self._n_refs
        self._n_refs += 1
        return i

    def record(
        self,
        probe: _Probe,
        *,
        step: int,
        k: int,
        batch,
        is_macro: bool,
        t_fetch_start: float,
        t_fetch_end: float,
        t_dispatch_start: float,
        t_dispatch_end: float,
        acc=None,
    ) -> None:
        """One dispatch: ``step`` is the epoch's optimizer-step count
        after it, ``k`` the steps it covered, ``batch`` its first host
        batch. The loss (the macro's running ``loss_sum``; a single
        step's loss and its real graph count) is copied into the epoch's
        device buffer here, outside any graph, before the next replay
        overwrites it; nothing is fetched until ``finish``."""
        spec, n_pad, e_pad, g_pad = _spec_of(batch)
        wall_start = self._prev_end if self._prev_end is not None else t_fetch_start
        self._prev_end = t_dispatch_end
        row = {
            "t": "step",
            "region": self.region,
            "epoch": self.epoch,
            "step": int(step),
            "k": int(k),
            "lanes": self.d,
            "feed": self.feed,
            "scheme": self.scheme,
            "spec": spec,
            "nodes_pad": n_pad,
            "edges_pad": e_pad,
            "graphs_pad": g_pad,
            "input_wait_ms": round(1e3 * (t_fetch_end - t_fetch_start), 4),
            "dispatch_ms": round(1e3 * (t_dispatch_end - t_dispatch_start), 4),
            "wall_ms": round(1e3 * (t_dispatch_end - wall_start), 4),
        }
        if self.lr is not None:
            row["lr"] = float(self.lr)
        # Plan-domain real sizes: k steps x d lanes consume k*d plan
        # entries (rows are (nodes + 1 pad slot, edges, graphs + 1)).
        rows = self._size_rows
        take = int(k) * self.d
        if rows is not None and self._size_cursor + take <= len(rows):
            sl = rows[self._size_cursor: self._size_cursor + take]
            row["nodes"] = int(sl[:, 0].sum()) - take
            row["edges"] = int(sl[:, 1].sum())
            row["graphs_plan"] = int(sl[:, 2].sum()) - take
        self._size_cursor += take
        self._n_records += 1
        bump("dispatches")
        bump("opt_steps", int(k))
        out = probe.out
        loss_src = acc[0] if is_macro else (out[0][0] if out is not None else None)
        if loss_src is not None:
            i = self._slot(loss_src.device)
            self._buf[i, 0].copy_(loss_src)
            row["_ref"] = i
            row["_loss_field"] = "loss_sum" if is_macro else "loss"
            if not is_macro:
                self._buf[i, 1].copy_(out[2][0])
            if self.sync_interval > 0 and self._n_records % self.sync_interval == 0:
                # The sampled fence, the one opt-in sync of the clock: it
                # waits for the copied loss, so for everything queued before it.
                if loss_src.device.type == "cuda":
                    import torch

                    done = torch.cuda.Event()
                    done.record()
                    # graftlint: disable-next-line=host-sync -- config-gated sampled fence (Telemetry.sync_interval_steps > 0); the default interval 0 never reaches this line
                    done.synchronize()
                row["device_complete_ms"] = round(
                    1e3 * (time.perf_counter() - t_dispatch_start), 4)
        self._rows.append(row)
        if probe.counter is not None:
            self._execs.append((self._exec_row(spec, int(k), probe.counter), probe.counter))
        obs = _OBSERVER
        if obs is not None and obs.memory_due:
            obs.memory_due = False
            emit_memory("compile", epoch=obs.phase)

    def _exec_row(self, spec: str, k: int, ctr: ExecCounter) -> dict:
        """The ``executable`` row of a counted dispatch (emitted by
        ``finish``, once the graph cache may have captured the step)."""
        key = (self.region, spec, k, self.d)
        row = {"t": "executable", "region": self.region, "epoch": self.epoch,
               "feed": self.feed, "scheme": self.scheme, "spec": spec, "k": k,
               "lanes": self.d}
        if not ctr.ran or ctr.error is not None:
            self.stream.exec_capture_failures += 1
            row["capture_error"] = ctr.error or (
                "not counted: the graph cache had run this step before its first "
                "telemetry dispatch")
            return row
        row["capture_ms"] = round(1e3 * ctr.seconds, 3)
        row["flops"] = ctr.flops
        row["bytes_accessed"] = ctr.bytes
        row["argument_bytes"] = ctr.argument_bytes
        row["output_bytes"] = ctr.output_bytes
        if ctr.kernels:
            row["kernels"] = {name: dict(v) for name, v in ctr.kernels.items()}
        obs = _OBSERVER
        if obs is not None and 0 <= obs.warmup_phase <= self.epoch:
            row["post_warmup"] = True
        self.stream.exec_captured += 1
        if ctr.flops:
            self.stream.exec_stats[key] = {"flops": ctr.flops, "bytes": ctr.bytes}
        return row

    def finish(self) -> None:
        """Fetch the epoch's copied losses in one transfer and emit the
        executable rows, the step rows and the per-spec rollups. Runs
        after the loop's own fetch of the epoch's sums."""
        vals = None
        if self._n_refs:
            # graftlint: disable-next-line=host-sync -- ONE batched epoch-end fetch of already-computed scalars (the loop's own metrics fetch has already drained the queue)
            vals = self._buf[: self._n_refs].cpu().numpy()
        for row, ctr in self._execs:
            if ctr.graphs is not None and "flops" in row:
                captured = ctr.graphs.graphs.get(ctr.graph_key)
                if captured is not None:
                    row["temp_bytes"] = int(captured.pool_bytes)
            self.stream.emit(row)
        specs: Dict[str, dict] = {}
        for row in self._rows:
            ri = row.pop("_ref", None)
            lf = row.pop("_loss_field", "loss")
            if ri is not None:
                row[lf] = float(vals[ri, 0])
                if lf == "loss":
                    row["graphs"] = float(vals[ri, 1])
            agg = specs.setdefault(
                row["spec"],
                {
                    "dispatches": 0,
                    "steps": 0,
                    "input_wait_ms": 0.0,
                    "dispatch_ms": 0.0,
                    "wall_ms": 0.0,
                    "device_complete_ms": 0.0,
                    "device_samples": 0,
                    "nodes": 0,
                    "edges": 0,
                    "graphs": 0.0,
                    "have_sizes": True,
                    "_hw_flops": 0.0,
                    "_hw_bytes": 0.0,
                    "_hw_dispatches": 0,
                    "_hw_missing": 0,
                },
            )
            agg["dispatches"] += 1
            agg["steps"] += row["k"]
            hw = self.stream.exec_stats.get((self.region, row["spec"], row["k"], self.d))
            if hw:
                agg["_hw_flops"] += hw["flops"]
                agg["_hw_bytes"] += hw["bytes"] or 0.0
                agg["_hw_dispatches"] += 1
            else:
                agg["_hw_missing"] += 1
            agg["input_wait_ms"] += row["input_wait_ms"]
            agg["dispatch_ms"] += row["dispatch_ms"]
            agg["wall_ms"] += row["wall_ms"]
            if "device_complete_ms" in row:
                agg["device_complete_ms"] += row["device_complete_ms"]
                agg["device_samples"] += 1
            if "nodes" in row:
                agg["nodes"] += row["nodes"]
                agg["edges"] += row["edges"]
            else:
                agg["have_sizes"] = False
            if "graphs" in row:
                agg["graphs"] += row["graphs"]
            elif "graphs_plan" in row:
                agg["graphs"] += row["graphs_plan"]
            self.stream.emit(row)
        self._rows, self._execs, self._n_refs = [], [], 0
        if not self.stream.rollup or not specs:
            return
        from hydragnn_tpu_torch.utils.flops import (
            model_flops_per_graph,
            resolve_peak_bandwidth,
            resolve_peak_flops,
        )

        peak, basis = resolve_peak_flops(self.stream.device_kind)
        peak_bw, bw_basis = resolve_peak_bandwidth(self.stream.device_kind)
        for spec, agg in specs.items():
            have_sizes = agg.pop("have_sizes")
            hw_flops = agg.pop("_hw_flops")
            hw_bytes = agg.pop("_hw_bytes")
            hw_dispatches = agg.pop("_hw_dispatches")
            hw_missing = agg.pop("_hw_missing")
            out = {
                "t": "spec_rollup",
                "region": self.region,
                "epoch": self.epoch,
                "feed": self.feed,
                "scheme": self.scheme,
                "lanes": self.d,
                "spec": spec,
                **{kk: (round(vv, 4) if isinstance(vv, float) else vv)
                   for kk, vv in agg.items()},
            }
            # Derived from the EMITTED fields, so a reader recomputing
            # flops(cfg, mean_nodes, mean_edges) * graphs / wall / peak
            # from the row reproduces ``mfu``.
            graphs = out["graphs"]
            wall_s = out["wall_ms"] / 1e3
            if graphs > 0 and wall_s > 0:
                out["graphs_per_sec"] = round(graphs / wall_s, 3)
            if self.model_cfg is not None and have_sizes and graphs > 0 and wall_s > 0:
                out["mean_nodes"] = agg["nodes"] / graphs
                out["mean_edges"] = agg["edges"] / graphs
                mf = model_flops_per_graph(self.model_cfg, out["mean_nodes"],
                                           out["mean_edges"])
                if mf:
                    achieved = mf * graphs / wall_s
                    out["model_flops_per_graph"] = mf
                    out["achieved_flops_per_sec"] = achieved
                    if peak:
                        out["peak_flops"] = peak
                        out["peak_basis"] = basis
                        out["mfu"] = achieved / peak
            # The counted side, only at full coverage (a partly counted
            # epoch reports its sums and the miss count, never a diluted
            # utilization).
            if hw_dispatches:
                out["hw_dispatches"] = hw_dispatches
                if hw_missing:
                    out["hw_missing_dispatches"] = hw_missing
                out["hw_flops"] = round(hw_flops, 4)
                if hw_bytes > 0:
                    out["hw_bytes_accessed"] = round(hw_bytes, 4)
                if hw_missing == 0 and wall_s > 0:
                    hw_rate = out["hw_flops"] / wall_s
                    out["hw_flops_per_sec"] = hw_rate
                    if peak:
                        out.setdefault("peak_flops", peak)
                        out.setdefault("peak_basis", basis)
                        out["hw_mfu"] = hw_rate / out["peak_flops"]
                    if hw_bytes > 0:
                        out["intensity"] = out["hw_flops"] / out["hw_bytes_accessed"]
                    if peak_bw:
                        out["peak_hbm_bytes_per_sec"] = peak_bw
                        out["peak_hbm_basis"] = bw_basis
                    if "model_flops_per_graph" in out and graphs > 0:
                        out["hw_over_model_flops"] = out["hw_flops"] / (
                            out["model_flops_per_graph"] * graphs)
            elif hw_missing and self.stream.cost_analysis:
                out["hw_missing_dispatches"] = hw_missing
            self.stream.emit(out)


def epoch_clock(loader, region: str, step0: int = 0) -> Optional[StepClock]:
    """The epoch's ``StepClock`` off the active stream (None when
    telemetry is off: the loop then pays one ``is None`` test per
    dispatch). Feed, scheme and lanes come from the loader chain, the
    plan-domain sizes from its base loader's ``epoch_size_rows``, the
    model config and learning rate from the run context."""
    stream = _ACTIVE
    if stream is None:
        return None
    feed, scheme_hint, d, base = _feed_labels(loader)
    plan_epoch = int(getattr(base, "_epoch", 0) or 0)
    ctx = _CONTEXT
    epoch = int(ctx["epoch"]) if "epoch" in ctx else plan_epoch
    size_rows = None if base is None else base.epoch_size_rows(plan_epoch)
    return StepClock(
        stream,
        region=region,
        epoch=epoch,
        feed=feed,
        scheme=scheme_hint or ctx.get("scheme") or "single",
        d=d,
        step0=step0,
        size_rows=size_rows,
        model_cfg=ctx.get("model_cfg"),
        lr=ctx.get("lr"),
    )


# ----------------------------------------------------------------------
# Compile (capture) observer
# ----------------------------------------------------------------------

_OBSERVER: Optional["CompileObserver"] = None
# True while a deliberate capture runs (the serving engine's warm-up):
# hidden from the observer, so a warm-up never reads as a leak storm.
# Set on the capturing thread between its own captures.
_SUPPRESS_COMPILE_EVENTS = False


@contextlib.contextmanager
def suppress_compile_events():
    """Hide the enclosed deliberate captures from the retrace-leak
    observer. Steady-state work must never run inside it."""
    global _SUPPRESS_COMPILE_EVENTS
    prev = _SUPPRESS_COMPILE_EVENTS
    _SUPPRESS_COMPILE_EVENTS = True
    try:
        yield
    finally:
        _SUPPRESS_COMPILE_EVENTS = prev


def note_capture(seconds: float) -> None:
    """The graph cache's hook after each capture (``train/capture.py``):
    host bookkeeping only, no CUDA call."""
    if _SUPPRESS_COMPILE_EVENTS:
        return
    obs = _OBSERVER
    if obs is not None:
        obs.on_capture(seconds)


def _build_cache_counts() -> Tuple[int, int]:
    from hydragnn_tpu_torch.ops import cuda_build

    return cuda_build.cache_stats["hits"], cuda_build.cache_stats["misses"]


class CompileObserver:
    """Counts CUDA-graph captures (the port's compiles) and their
    seconds; a capture at phase >= ``warmup_phase`` (phases are epochs;
    1 = after epoch 0) is flagged a retrace leak. Rows go to the
    attached stream; ``memory_due`` asks the loop thread for a
    ``memory`` row after a capture. ``summary()``'s cache hits and
    misses are the kernel library build cache's (``ops/cuda_build.py``:
    loaded as built, or built) over the observer's life."""

    def __init__(self, stream: Optional[TelemetryStream] = None,
                 warmup_phase: int = 1) -> None:
        self.stream = stream
        self.warmup_phase = int(warmup_phase)
        self.phase = 0
        self.compile_count = 0
        self.compile_ms = 0.0
        self.events: List[dict] = []
        self.post_warmup: List[dict] = []
        self.memory_due = False
        self._cache0 = _build_cache_counts()

    def install(self) -> "CompileObserver":
        global _OBSERVER
        _OBSERVER = self
        return self

    def close(self) -> None:
        """Detach and emit the summary row."""
        global _OBSERVER
        if self.stream is not None:
            self.stream.emit({"t": "compile_summary", **self.summary()})
        if _OBSERVER is self:
            _OBSERVER = None

    def set_phase(self, phase: int) -> None:
        self.phase = int(phase)

    def on_capture(self, seconds: float) -> None:
        ms = 1e3 * float(seconds)
        self.compile_count += 1
        self.compile_ms += ms
        leak = 0 <= self.warmup_phase <= self.phase
        ev = {"seq": self.compile_count, "epoch": self.phase, "ms": round(ms, 3),
              "retrace_leak": leak}
        self.events.append(ev)
        if leak:
            self.post_warmup.append(ev)
            print(
                f"[telemetry] RETRACE LEAK: CUDA-graph capture #{self.compile_count} "
                f"({ms:.1f}ms) during epoch {self.phase} — steady-state epochs should "
                "replay captured graphs (a new batch shape reaching the step is the "
                "usual cause)",
                flush=True,
            )
        if self.stream is not None:
            self.stream.emit({"t": "compile", **ev})
            self.memory_due = True

    def summary(self) -> dict:
        hits, misses = _build_cache_counts()
        return {
            "compile_count": self.compile_count,
            "compile_ms": round(self.compile_ms, 3),
            "cache_hits": hits - self._cache0[0],
            "cache_misses": misses - self._cache0[1],
            "post_warmup_compiles": len(self.post_warmup),
        }


def install_observer(stream: Optional[TelemetryStream] = None,
                     warmup_phase: int = 1) -> CompileObserver:
    return CompileObserver(stream, warmup_phase).install()


def observer() -> Optional[CompileObserver]:
    return _OBSERVER
