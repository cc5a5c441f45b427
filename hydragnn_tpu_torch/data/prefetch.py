"""The prefetch thread: a wrapped loader iterated one step ahead.

Counterpart of ``hydragnn_tpu/data/prefetch.py`` (the reference's
``HydraDataLoader``: a fetch thread). A worker thread iterates the wrapped loader (collation, superstep
grouping, a dp slot's deliveries) into a bounded queue while the loop
thread runs the step.

The worker hands host batches over and never touches the card: where
the JAX package's worker calls ``jax.device_put``, the port's
host-to-device copy stays on the loop thread (``train/capture.py``:
``StaticBatches.load`` for a replay, ``GraphBatch.to`` for a shape's
first, eager step). A CUDA call from this thread could land inside a
capture the loop thread is recording, which ``capture_error_mode
"global"`` turns into a failed capture.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class PrefetchLoader:
    """Wraps any batch iterable; yields its items with up to ``depth``
    of them collated ahead in a worker thread. A worker's exception is
    raised on the consumer in order; the worker exits when the consumer
    closes the iteration early."""

    # skip_to is pure delegation: data/loader.feed_supports_skip asks the
    # wrapped loader whether it can fast-forward.
    _skip_to_delegates = True

    def __init__(self, loader, *, depth: int = 2):
        self.loader = loader
        self.depth = max(1, int(depth))

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def skip_to(self, step) -> None:
        """Mid-epoch resume cursor, handed to the wrapped loader, which
        owns the plan-domain fast-forward."""
        inner = getattr(self.loader, "skip_to", None)
        if inner is None:
            raise AttributeError(
                f"PrefetchLoader wraps {type(self.loader).__name__}, which has no skip_to "
                "fast-forward (probe data/loader.feed_supports_skip before arming a cursor)"
            )
        inner(step)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has gone (a
            plain put would block forever on a full queue nobody reads)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            it = iter(self.loader)
            try:
                for item in it:
                    if stop.is_set() or not put(item):
                        return
            except BaseException as e:  # raised on the consumer, in order
                put(e)
                return
            finally:
                close = getattr(it, "close", None)
                if close is not None:  # a wrapped pipeline stops its workers
                    close()
            put(done)

        t = threading.Thread(target=worker, daemon=True, name="hgtpu-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
