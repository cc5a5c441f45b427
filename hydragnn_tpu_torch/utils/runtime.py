"""The job's walltime, for the epoch loop's stop, and memory readings.

Counterpart of ``hydragnn_tpu/utils/runtime.py``: ``job_end_time`` and
``check_remaining`` (whose cross-rank broadcast is a telemetry
``barrier`` row, site ``walltime``), ``memory_stats`` (the caching
allocator's counters under the JAX package's key names),
``host_memory`` and ``print_peak_memory``. The JAX package's persistent
compilation cache has no counterpart: the port's one build cache is the
kernel library's (``ops/cuda_build.py``), which the compile observer
reports (``utils/telemetry.CompileObserver``).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Optional

_SQUEUE_CACHE: list = []


def job_end_time() -> Optional[float]:
    """Epoch seconds when the job ends: ``HYDRAGNN_WALLCLOCK_DEADLINE``,
    else ``SLURM_JOB_END_TIME``, else one ``squeue`` probe per process
    (only with ``SLURM_JOB_ID`` set); None when none says."""
    for name in ("HYDRAGNN_WALLCLOCK_DEADLINE", "SLURM_JOB_END_TIME"):
        v = os.environ.get(name)
        if v:
            return float(v)
    if _SQUEUE_CACHE:
        return _SQUEUE_CACHE[0]
    _SQUEUE_CACHE.append(None)
    job = os.environ.get("SLURM_JOB_ID")
    if job:
        try:
            out = subprocess.run(["squeue", "-h", "-j", job, "-O", "TimeLeft"],
                                 capture_output=True, text=True, timeout=10).stdout.strip()
            if out:
                parts = out.split("-")
                days = int(parts[0]) if len(parts) == 2 else 0
                hms = [int(x) for x in parts[-1].split(":")]
                hms = [0] * (3 - len(hms)) + hms
                _SQUEUE_CACHE[0] = time.time() + days * 86400 + hms[0] * 3600 + hms[1] * 60 + hms[2]
        except Exception:
            pass
    return _SQUEUE_CACHE[0]


def check_remaining(min_seconds_left: float = 300.0) -> bool:
    """True while training may go on; False within ``min_seconds_left``
    of the job's end. Under several ranks rank 0's answer is broadcast,
    so every rank leaves the epoch loop together."""
    end = job_end_time()
    ok = end is None or (end - time.time()) > min_seconds_left
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from hydragnn_tpu_torch.utils import telemetry

        _WALLTIME_SEQ[0] += 1
        seq = _WALLTIME_SEQ[0]
        box = [ok]
        # A broadcast is asymmetric (only ranks arriving before rank 0
        # wait), so the row is marked ``broadcast``.
        with telemetry.waiting_on("walltime"):
            t0 = time.perf_counter()
            try:
                dist.broadcast_object_list(box, src=0)
            except BaseException:
                telemetry.emit_barrier("walltime", seq, time.perf_counter() - t0,
                                       timed_out=True, broadcast=True)
                raise
            dt = time.perf_counter() - t0
        telemetry.emit_barrier("walltime", seq, dt, broadcast=True)
        ok = bool(box[0])
    return ok


_WALLTIME_SEQ = [0]


def memory_stats() -> dict:
    """Per-card allocator counters (bytes) under the JAX package's key
    names: ``bytes_in_use`` (allocated now), ``peak_bytes_in_use`` and
    ``bytes_limit`` (the card's total memory), keyed ``cuda:<i>``. Empty
    when CUDA is not initialized (reading it never initializes a
    device) and on the CPU. A card that cannot answer is left out: a
    memory reading never raises into a run."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        try:
            s = torch.cuda.memory_stats(i)
            entry = {
                "bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            }
        except (RuntimeError, AssertionError):
            continue
        out[f"cuda:{i}"] = entry
    return out


def host_memory() -> dict:
    """The process's host memory (bytes): ``host_rss_bytes`` (now, from
    /proc/self/statm) and ``host_peak_rss_bytes`` (ru_maxrss); a field
    whose source is missing is left out."""
    out = {}
    try:
        import resource

        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        out["host_peak_rss_bytes"] = int(peak_kb) * 1024  # linux: KiB
    except (ImportError, OSError):
        pass
    try:
        # graftlint: disable-next-line=thread-discipline -- procfs, not disk: a few bytes of this process's RSS, read by the memory rows at epoch boundaries and after captures, never per step
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out["host_rss_bytes"] = rss_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return out


def print_peak_memory(verbosity_fn=print) -> None:
    for dev, s in memory_stats().items():
        peak = s.get("peak_bytes_in_use")
        lim = s.get("bytes_limit")
        if peak is not None:
            msg = f"{dev}: peak memory {peak / 2**30:.2f} GiB"
            if lim:
                msg += f" / {lim / 2**30:.2f} GiB"
            verbosity_fn(msg)
