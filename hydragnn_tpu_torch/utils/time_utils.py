"""Wall-clock region timers.

Counterpart of ``hydragnn_tpu/utils/time_utils.py``: ``Timer`` (a named
accumulator of wall seconds and calls, kept in a module registry, usable
as a context manager), ``reset_timers`` and ``print_timers`` (one line
per timer through ``print_utils.print_distributed``, so rank 0 prints).
Each process keeps and prints its own totals; nothing is reduced across
processes, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Dict

_TIMERS: Dict[str, "Timer"] = {}


class Timer:
    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._start = None
        _TIMERS[name] = self

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> None:
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self.count += 1
            self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def reset_timers() -> None:
    _TIMERS.clear()


def print_timers(verbosity: int = 1) -> None:
    from hydragnn_tpu_torch.utils.print_utils import print_distributed

    for name, t in sorted(_TIMERS.items()):
        avg = t.total / max(t.count, 1)
        print_distributed(
            verbosity,
            1,
            f"timer {name}: total {t.total:.4f}s count {t.count} avg {avg:.4f}s",
        )
