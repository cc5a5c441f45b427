"""Region tracing and the profiler window.

Counterpart of ``hydragnn_tpu/utils/tracer.py``: a registry of optional
tracers driven by ``start``/``stop``/``sample`` (``initialize``, the
``@profile`` decorator, ``enable``/``disable``/``reset``/``has`` and a
per-process CSV ``save``), and the epoch-gated profiler.

- ``RegionTimer``: nested wall-clock regions with call counts, min and
  max; its CSV is ``logs/<run>/timing.p<rank>.csv``.
- ``DeviceMetricsTracer``: per-region device counters, the caching
  allocator's bytes in use and peak (``torch.cuda.memory_stats``) and a
  utilization sample from ``nvidia-smi --query-gpu=utilization.gpu``
  (at most one process every 5 s, the cached value between). Inert
  without an initialized CUDA device (the CPU), so always safe.
- ``TorchProfilerTracer``: one ``torch.profiler`` window around the
  region named ``region`` (the JAX package's ``JaxProfilerTracer``).
- ``Profiler``: ``Training.Profiling {enabled, epoch, steps, trace_dir}``
  (or the legacy ``Profile {enable, target_epoch, trace_dir}``): a
  ``torch.profiler`` trace of epoch ``epoch``, bounded to its first
  ``steps`` dispatches (0 = the whole epoch), written as a chrome trace
  into ``trace_dir``; the window's start and stop are ``profile`` rows
  of the run's telemetry. While a window is live every dispatch runs
  inside ``step_annotation``: a ``torch.profiler.record_function``
  named ``train_step``/``eval_step`` whose argument string carries the
  step, spec and k, so the card's kernels align to the loop's steps.

``sync=True`` on ``start``/``stop`` synchronizes the current CUDA device
first, so a region times device completion.
"""

from __future__ import annotations

import contextlib
import csv
import functools
import os
import shutil
import subprocess
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "initialize",
    "start",
    "stop",
    "sample",
    "profile",
    "enable",
    "disable",
    "reset",
    "save",
    "has",
    "Profiler",
    "RegionTimer",
    "DeviceMetricsTracer",
    "TorchProfilerTracer",
    "set_trace_step_budget",
    "note_trace_step",
    "step_annotation",
]

_TRACERS: Dict[str, Any] = {}


class RegionTimer:
    """Nested wall-clock regions: total / count / min / max per name."""

    def __init__(self) -> None:
        self._open: Dict[str, float] = {}
        self._stack: List[str] = []
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.mins: Dict[str, float] = {}
        self.maxs: Dict[str, float] = {}
        self.enabled = True

    def start(self, name: str) -> None:
        if not self.enabled:
            return
        self._stack.append(name)
        self._open[self._key()] = time.perf_counter()

    def stop(self, name: str) -> None:
        if not self.enabled:
            return
        key = self._key()
        t0 = self._open.pop(key, None)
        if self._stack and self._stack[-1] == name:
            self._stack.pop()
        if t0 is None:
            return
        self.add_sample(key, time.perf_counter() - t0)

    def _key(self) -> str:
        return "/".join(self._stack)

    def add_sample(self, name: str, value: float) -> None:
        """One observation of ``name`` measured elsewhere (same
        total/count/min/max as a start/stop pair)."""
        if not self.enabled:
            return
        self.totals[name] = self.totals.get(name, 0.0) + value
        self.counts[name] = self.counts.get(name, 0) + 1
        self.mins[name] = min(self.mins.get(name, value), value)
        self.maxs[name] = max(self.maxs.get(name, value), value)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Clear the measurements, not the switch."""
        enabled = self.enabled
        self.__init__()
        self.enabled = enabled

    def save_csv(self, path: str, device_columns: Optional[Dict[str, Dict]] = None) -> None:
        """One row per region; ``device_columns`` ({region: {column:
        value}}, the DeviceMetricsTracer's) merged in."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra: List[str] = []
        for cols in (device_columns or {}).values():
            extra += [name for name in cols if name not in extra]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["region", "count", "total_s", "min_s", "max_s", "avg_s"] + extra)
            for k in sorted(self.totals):
                c = self.counts[k]
                cols = (device_columns or {}).get(k, {})
                w.writerow([k, c, f"{self.totals[k]:.6f}", f"{self.mins[k]:.6f}",
                            f"{self.maxs[k]:.6f}", f"{self.totals[k] / max(c, 1):.6f}"]
                           + [cols.get(name, "") for name in extra])


_UTIL_CACHE = {"exe": False, "t": 0.0, "value": None}
_UTIL_MIN_INTERVAL_S = 5.0


def _read_gpu_utilization() -> Optional[float]:
    """The card's utilization (percent) from ``nvidia-smi``, at most one
    process per ``_UTIL_MIN_INTERVAL_S`` (regions open and close several
    times a step), the cached value between; None without the tool."""
    if _UTIL_CACHE["exe"] is False:
        _UTIL_CACHE["exe"] = shutil.which("nvidia-smi")
    exe = _UTIL_CACHE["exe"]
    if exe is None:
        return None
    now = time.monotonic()
    if now - _UTIL_CACHE["t"] < _UTIL_MIN_INTERVAL_S:
        return _UTIL_CACHE["value"]
    _UTIL_CACHE["t"] = now
    value = None
    try:
        import torch

        proc = subprocess.run(
            [exe, "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=2)
        if proc.returncode == 0:
            v = float(proc.stdout.strip().splitlines()[0])
            value = v if 0.0 <= v <= 100.0 else None
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        value = None
    _UTIL_CACHE["value"] = value
    return value


def _default_device_counters() -> Optional[Dict[str, float]]:
    """The current card's allocator counters and utilization; None
    without an initialized CUDA device (the tracer then stays inert)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    out = {
        "hbm_bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "hbm_peak_bytes": float(stats.get("allocated_bytes.all.peak", 0)),
    }
    util = _read_gpu_utilization()
    if util is not None:
        out["utilization_pct"] = util
    return out


class DeviceMetricsTracer:
    """Per-region device counters sampled at region start and stop:
    ``<name>_delta`` (the sum of stop - start over calls) and
    ``<name>_max`` (the largest value at a boundary). ``read_fn`` is
    injectable (tests, other pollers)."""

    def __init__(self, read_fn: Optional[Callable] = None) -> None:
        self._read = read_fn or _default_device_counters
        self.active = self._read() is not None
        self.enabled = True
        self._open: Dict[str, Dict[str, float]] = {}
        self._stack: List[str] = []
        self.deltas: Dict[str, Dict[str, float]] = {}
        self.maxes: Dict[str, Dict[str, float]] = {}

    def start(self, name: str) -> None:
        if not (self.enabled and self.active):
            return
        self._stack.append(name)
        snap = self._read()
        if snap is not None:
            self._open[self._key()] = snap

    def stop(self, name: str) -> None:
        if not (self.enabled and self.active) or name not in self._stack:
            return
        # Drop the opens of regions started above ``name`` and never
        # stopped.
        while self._stack[-1] != name:
            self._open.pop(self._key(), None)
            self._stack.pop()
        key = self._key()
        self._stack.pop()
        before = self._open.pop(key, None)
        after = self._read()
        if before is None or after is None:
            return
        d = self.deltas.setdefault(key, {})
        m = self.maxes.setdefault(key, {})
        for cname, val in after.items():
            d[cname] = d.get(cname, 0.0) + (val - before.get(cname, val))
            m[cname] = max(m.get(cname, val), val, before.get(cname, val))

    def _key(self) -> str:
        return "/".join(self._stack)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._open.clear()
        self._stack.clear()
        self.deltas.clear()
        self.maxes.clear()

    def columns(self) -> Dict[str, Dict[str, float]]:
        """{region: {csv column: value}} for ``RegionTimer.save_csv``."""
        out: Dict[str, Dict[str, float]] = {}
        for key in set(self.deltas) | set(self.maxes):
            cols = {f"{c}_delta": v for c, v in self.deltas.get(key, {}).items()}
            cols.update({f"{c}_max": v for c, v in self.maxes.get(key, {}).items()})
            out[key] = cols
        return out


# One profiler window at a time, shared by TorchProfilerTracer and
# Profiler.
_PROF = None
_PROF_PATH: Optional[str] = None
_TRACE_STEP_BUDGET: Optional[int] = None  # dispatches left in the window
_NULL_CTX = contextlib.nullcontext()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _start_trace(trace_dir: str) -> bool:
    """Start the profiler (CPU, and CUDA where a card is initialized);
    False when a window is live already."""
    global _PROF, _PROF_PATH
    if _PROF is not None:
        return False
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _PROF = prof
    _PROF_PATH = os.path.join(trace_dir, f"trace.p{_rank()}.json")
    return True


def _stop_trace() -> None:
    """Stop the live window (after the card finishes its work) and
    write its chrome trace."""
    global _PROF, _PROF_PATH, _TRACE_STEP_BUDGET
    prof, path = _PROF, _PROF_PATH
    _PROF = _PROF_PATH = None
    _TRACE_STEP_BUDGET = None
    if prof is None:
        return
    import torch

    if torch.cuda.is_initialized():
        # graftlint: disable-next-line=host-sync -- closing a profiler window (Profiling.steps, opt-in): the card's queued work must land in the trace, once per window
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)


def close_window() -> None:
    """Stop a window a failed run left live (no row: the run ended)."""
    if _PROF is not None:
        _stop_trace()


def set_trace_step_budget(steps: Optional[int]) -> None:
    """Bound the live window to ``steps`` dispatches (None: the epoch)."""
    global _TRACE_STEP_BUDGET
    _TRACE_STEP_BUDGET = int(steps) if steps else None


def note_trace_step() -> None:
    """One dispatch of the live window; stops it (with a ``profile``
    stop row) when the step budget is spent. A no-op without a window
    or a budget."""
    global _TRACE_STEP_BUDGET
    if _PROF is None or _TRACE_STEP_BUDGET is None:
        return
    _TRACE_STEP_BUDGET -= 1
    if _TRACE_STEP_BUDGET <= 0:
        _stop_trace()
        _emit_profile_row("stop", reason="step_budget")


def step_annotation(region: str, step: int, batch=None, k: int = 1):
    """A ``record_function`` named ``region`` carrying ``step``, the
    batch's spec and ``k`` while a window is live; a shared no-op
    context otherwise."""
    if _PROF is None:
        return _NULL_CTX
    import torch

    meta = f"step={int(step)} k={int(k)}"
    if batch is not None:
        meta += (f" spec=n{int(batch.node_mask.shape[-1])}_e{int(batch.edge_mask.shape[-1])}"
                 f"_g{int(batch.graph_mask.shape[-1])}")
    return torch.profiler.record_function(region, meta)


def _emit_profile_row(event: str, **kw) -> None:
    from hydragnn_tpu_torch.utils import telemetry

    telemetry.emit({"t": "profile", "event": event, **kw})


class TorchProfilerTracer:
    """One ``torch.profiler`` window around the region named ``region``
    (default "trace") while enabled; the loop's per-step regions do not
    match it."""

    def __init__(self, trace_dir: str = "logs/torch_trace", region: str = "trace") -> None:
        self.trace_dir = trace_dir
        self.region = region
        self.enabled = False
        self._owner = False

    def start(self, name: str) -> None:
        if self.enabled and name == self.region:
            self._owner = _start_trace(self.trace_dir)

    def stop(self, name: str) -> None:
        if self.enabled and name == self.region and self._owner:
            _stop_trace()
            self._owner = False

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._owner = False


def initialize(trlist: Optional[List[str]] = None, verbose: bool = False, **kwargs) -> None:
    """Install tracers by name; keyword arguments go to the tracers
    whose constructors take them."""
    import inspect

    classes = {
        "RegionTimer": RegionTimer,
        "TorchProfilerTracer": TorchProfilerTracer,
        "DeviceMetricsTracer": DeviceMetricsTracer,
    }
    for name in trlist or ["RegionTimer"]:
        cls = classes[name]
        accepted = set(inspect.signature(cls.__init__).parameters)
        _TRACERS[name] = cls(**{k: v for k, v in kwargs.items() if k in accepted})
        if verbose:
            print(f"tracer installed: {name}")


def has(name: str) -> bool:
    return name in _TRACERS


def _device_sync() -> None:
    import torch

    if torch.cuda.is_initialized():
        # graftlint: disable-next-line=host-sync -- this IS the sync barrier: the opt-in fence of start/stop(sync=True), so a region times device completion
        torch.cuda.synchronize()


def start(name: str, sync: bool = False) -> None:
    if sync:
        _device_sync()
    for t in _TRACERS.values():
        t.start(name)


def stop(name: str, sync: bool = False) -> None:
    if sync:
        _device_sync()
    for t in _TRACERS.values():
        t.stop(name)


def sample(name: str, value: float) -> None:
    """One observation of ``name`` on every tracer that takes samples."""
    for t in _TRACERS.values():
        add = getattr(t, "add_sample", None)
        if add is not None:
            add(name, value)


def profile(name: str, sync: bool = False) -> Callable:
    """Decorator timing every call as region ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            start(name, sync=sync)
            try:
                return fn(*a, **kw)
            finally:
                stop(name, sync=sync)

        return wrapped

    return deco


def enable() -> None:
    for t in _TRACERS.values():
        t.enable()


def disable() -> None:
    for t in _TRACERS.values():
        t.disable()


def reset() -> None:
    for t in _TRACERS.values():
        t.reset()


def save(log_name: str) -> None:
    """The per-process CSV ``logs/<log_name>/timing.p<rank>.csv``."""
    if has("RegionTimer"):
        dm = _TRACERS.get("DeviceMetricsTracer")
        cols = dm.columns() if dm is not None and dm.active else None
        _TRACERS["RegionTimer"].save_csv(
            os.path.join("logs", log_name, f"timing.p{_rank()}.csv"), device_columns=cols)


class Profiler:
    """The epoch-gated profiler window (module docstring)."""

    def __init__(self, config: Optional[dict] = None) -> None:
        config = config or {}
        pcfg = config.get("NeuralNetwork", {}).get("Training", {}).get("Profiling") or {}
        if pcfg:
            self.enabled = bool(pcfg.get("enabled", True))
            self.target_epoch = int(pcfg.get("epoch", 0))
            self.steps = max(0, int(pcfg.get("steps", 0)))
            self.trace_dir = pcfg.get("trace_dir", "logs/torch_trace")
        else:
            cfg = config.get("Profile", {})
            self.enabled = bool(cfg.get("enable", 0))
            self.target_epoch = int(cfg.get("target_epoch", 0))
            self.steps = 0
            self.trace_dir = cfg.get("trace_dir", "logs/torch_trace")
        self._active = False
        self.trace_file: Optional[str] = None

    def on_epoch_start(self, epoch: int) -> None:
        if self.enabled and epoch == self.target_epoch:
            self._active = _start_trace(self.trace_dir)
            if self._active:
                self.trace_file = _PROF_PATH
                set_trace_step_budget(self.steps or None)
                _emit_profile_row("start", epoch=epoch, trace_dir=self.trace_dir,
                                  steps=self.steps or None)

    def on_epoch_end(self, epoch: int) -> None:
        if self._active:
            # the step budget may have closed the window already
            if _PROF is not None:
                _stop_trace()
                _emit_profile_row("stop", epoch=epoch, reason="epoch_end")
            self._active = False
