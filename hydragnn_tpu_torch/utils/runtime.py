"""The job's walltime, for the epoch loop's stop.

Counterpart of ``job_end_time`` and ``check_remaining`` in
``hydragnn_tpu/utils/runtime.py`` (the rest of that module, the
compilation cache and memory prints, is ROADMAP item 13).
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
        box = [ok]
        dist.broadcast_object_list(box, src=0)
        ok = bool(box[0])
    return ok
