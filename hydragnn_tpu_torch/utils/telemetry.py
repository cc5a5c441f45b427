"""Telemetry streams: the stream core.

Counterpart of the stream half of ``hydragnn_tpu/utils/telemetry.py``
(``TelemetryStream``, the active-stream functions, shard naming and the
liveness rows), with the JAX package's row and field names, so that
``tools/graftboard.py`` reads the port's shards unchanged
(docs/OBSERVABILITY.md). The step clock, the compile observer, memory
rows and the ``Training.Telemetry`` settings are ROADMAP Queue 1 item
13; the serving tier (``serve/fleet.py``) is this module's user today.

- ``TelemetryStream``: a bounded, non-blocking JSONL writer. ``emit`` is
  a ``put_nowait``; a full queue drops the row and counts it
  (``dropped``) instead of stalling the caller; a daemon worker batches
  rows into one write + flush, and absorbs I/O failures onto
  ``write_errors``/``last_error``. Rows are whole lines, so a kill
  mid-write leaves at most one truncated tail line (graftboard skips
  it). A header row opens the stream and a ``close`` accounting row
  ends a clean one; ``abandon`` stops it without the close row, as a
  killed process leaves its shard.
- Shards: process (or serving replica) ``i`` of a fleet writes
  ``shard_path(base, i)``, ``telemetry.jsonl`` -> ``telemetry.proc1.jsonl``,
  and every row is tagged with ``process_index`` on the worker thread.
- A heartbeat thread per stream emits ``heartbeat`` rows carrying the
  run phase (``note_phase``): graftboard's ``fleet`` view detects a dead
  process from a heartbeat gap with no close row. The blocking-wait site
  (``waiting_on``) and the liveness counters (``bump``) come with their
  callers, the checkpoint barriers and the data-parallel loops (ROADMAP
  Queue 1 item 13).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

__all__ = [
    "SCHEMA_VERSION",
    "TelemetryStream",
    "install",
    "get",
    "active",
    "emit",
    "process_identity",
    "shard_path",
    "note_phase",
    "get_phase",
    "heartbeat_row",
]


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
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                if idx is None:
                    idx = int(dist.get_rank())
                if cnt is None:
                    cnt = int(dist.get_world_size())
        except Exception:
            pass
    return (idx or 0, cnt or 1)


def shard_path(base: str, process_index: int) -> str:
    """The shard of process ``process_index`` for ``base``: process 0
    keeps ``base``; process ``i`` gets ``<root>.proc<i><ext>`` next to
    it, so one directory holds one run's whole fleet."""
    if process_index <= 0:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.proc{int(process_index)}{ext}"


def _self_description() -> dict:
    """Host and device facts for the ``header`` row. Device fields
    appear only when CUDA is already initialized: constructing a stream
    never initializes a device."""
    out: Dict[str, Any] = {}
    try:
        import socket

        out["hostname"] = socket.gethostname()
    except Exception:
        pass
    try:
        import torch

        out["torch_version"] = torch.__version__
        if torch.cuda.is_initialized():
            out["device_kind"] = torch.cuda.get_device_name(0)
            out["platform"] = "gpu"
            out["device_count"] = torch.cuda.device_count()
    except Exception:
        pass
    return out


def _json_default(x):
    """Serialize numpy scalars and arrays (anything exotic degrades to
    str rather than killing the worker)."""
    item = getattr(x, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:
            pass
    tolist = getattr(x, "tolist", None)
    if callable(tolist):
        try:
            return tolist()
        except Exception:
            pass
    return str(x)


class TelemetryStream:
    """Bounded non-blocking JSONL writer, one JSON object per line
    (module docstring). ``heartbeat_interval_s`` > 0 starts the
    heartbeat thread; ``process_index`` names the shard's process (the
    replica index in a serving tier); ``meta`` is merged into the
    header."""

    def __init__(
        self,
        path: str,
        *,
        queue_depth: int = 16384,
        heartbeat_interval_s: float = 0.0,
        process_index: Optional[int] = None,
        meta: Optional[dict] = None,
    ) -> None:
        self.path = path
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
        self._q: "queue.Queue" = queue.Queue(maxsize=max(64, queue_depth))
        self._stop = threading.Event()
        self._hb_stop = threading.Event()
        self._closed = False
        self._fh = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        header = {"t": "header", "schema": SCHEMA_VERSION, "pid": os.getpid(),
                  "sync_interval_steps": 0}
        header.update(_self_description())
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
                "executables": 0,
                "exec_capture_failures": 0,
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
                except Exception:
                    pass
                self._fh = None
        try:
            if self._fh is not None:
                self._fh.close()
        except Exception:
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
# The process's active stream
# ----------------------------------------------------------------------

_ACTIVE: Optional[TelemetryStream] = None


def install(stream: Optional[TelemetryStream]) -> None:
    """Install ``stream`` as the process's active stream. A new stream
    starts a new run's ledger: the phase resets.
    ``install(None)`` only detaches."""
    global _ACTIVE
    if stream is not None:
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


# ----------------------------------------------------------------------
# Liveness: run phase
# ----------------------------------------------------------------------

_PHASE = "startup"
_PHASE_TS = time.time()


def note_phase(name: str) -> None:
    """Advance the coarse run phase the heartbeat rows carry."""
    global _PHASE, _PHASE_TS
    _PHASE = str(name)
    _PHASE_TS = time.time()


def get_phase() -> str:
    return _PHASE


def heartbeat_row(seq: int, interval_s: float) -> Dict[str, Any]:
    """One liveness row: wall clock, run phase and its age."""
    now = time.time()
    return {
        "t": "heartbeat",
        "seq": int(seq),
        "ts": round(now, 3),
        "interval_s": interval_s,
        "phase": _PHASE,
        "phase_age_s": round(now - _PHASE_TS, 3),
    }
