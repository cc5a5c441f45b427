"""Deadline-driven dynamic batching into pack-budget shapes.

Counterpart of ``hydragnn_tpu/serve/batcher.py`` (``ServeRequest``,
``DynamicBatcher``), copied: it is pure host logic over the port's
``PackPlanner``. Requests are placed first-fit into open bins under the
largest fitted budget as they arrive; a bin is dispatched when it is
**full** (no graph slot left), under **pressure** (more than
``max_open_bins`` bins are open and it is the fullest), at its
**deadline** (its oldest request has waited ``deadline_ms``), or as a
**flush** after ``close()``. A dispatched bin is downshifted to the
smallest budget that holds it, so the shapes the engine warms at start
are exactly the budget set.

Pull-driven: ``next_bin`` is called by the engine's dispatch loop (one
consumer); ``submit`` is thread-safe for any number of frontends. The
batcher never touches the device.
"""

from __future__ import annotations

import itertools
import queue
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from hydragnn_tpu_torch.data.graph import GraphSample, PackSpec
from hydragnn_tpu_torch.data.padschedule import OpenBin, PackPlanner


class ServeRequest:
    """One in-flight request: the sample, its enqueue timestamp (the
    latency zero point), its deadline class (0 = best-effort batch, 1 =
    standard, 2 = interactive: the fleet router's shed order; a bare
    batcher ignores it), and the slots the engine fills at response
    time. Plain attributes, no locking — a request is owned by the submitting thread until
    ``submit`` and by the dispatch loop after."""

    __slots__ = (
        "sample",
        "req_id",
        "t_enqueue",
        "deadline_class",
        "result",
        "t_done",
        "latency_ms",
    )

    def __init__(
        self,
        sample: GraphSample,
        req_id: int,
        t_enqueue: float,
        deadline_class: int = 1,
    ):
        self.sample = sample
        self.req_id = int(req_id)
        self.t_enqueue = float(t_enqueue)
        self.deadline_class = int(deadline_class)
        self.result = None
        self.t_done: Optional[float] = None
        self.latency_ms: Optional[float] = None


class DynamicBatcher:
    """FFD-fill incoming graphs into ``PackSpec`` budget bins under a
    latency deadline (module docstring has the dispatch triggers).

    ``clock`` is injectable (tests drive deadlines deterministically
    with a fake clock); production uses ``time.monotonic``.
    """

    def __init__(
        self,
        budgets: Sequence[PackSpec],
        *,
        deadline_ms: float = 25.0,
        max_open_bins: int = 4,
        clock=time.monotonic,
    ):
        self.planner = PackPlanner(budgets, open_window=max_open_bins)
        self.deadline_s = max(float(deadline_ms), 0.0) / 1e3
        self.clock = clock
        self._q: "queue.Queue[ServeRequest]" = queue.Queue()
        self._ready: deque = deque()  # (reason, OpenBin)
        self._ids = itertools.count()
        self._closed = False

    # -- frontend side -------------------------------------------------

    def submit(
        self, sample: GraphSample, *, deadline_class: int = 1
    ) -> ServeRequest:
        """Enqueue one graph; returns its request handle (the engine
        fills ``result``/``latency_ms``). Thread-safe; never blocks.
        Raises when the graph exceeds the largest budget — an
        unservable request must fail at the door, not poison a bin.
        ``deadline_class`` is carried for the fleet router's shed
        accounting; the batcher batches all classes alike."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        if not self.planner.fits(sample.num_nodes, sample.num_edges):
            raise ValueError(
                f"request ({sample.num_nodes} nodes, "
                f"{sample.num_edges} edges) exceeds the largest pack "
                f"budget {self.planner.big} — refit budgets "
                "(fit_pack_budgets) over a histogram that covers it"
            )
        req = ServeRequest(
            sample, next(self._ids), self.clock(), deadline_class
        )
        # put_nowait, structurally: the queue is unbounded today, but
        # the never-blocks contract must survive someone adding a
        # maxsize — overflow policy is the front door's fits() check,
        # never a parked frontend thread.
        self._q.put_nowait(req)
        return req

    def close(self) -> None:
        """No further submits; ``next_bin`` drains what remains and
        then returns None."""
        self._closed = True

    def qsize(self) -> int:
        """Undispatched requests (queued + sitting in open bins): the
        queue depth each dispatched bin records."""
        return self._q.qsize() + sum(
            len(b.tags) for b in self.planner.open_bins
        )

    def oldest_anchor_age_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest open bin's deadline anchor (``b.meta["t0"]``,
        the stamp the deadline trigger fires on). Past the dispatch
        deadline, bins expire faster than they dispatch: the fleet
        router's shed policy reads this. 0.0 with no open bin. Safe from
        a frontend thread: it reads a snapshot of the open bins."""
        anchors = [
            b.meta["t0"]
            for b in list(self.planner.open_bins)
            if "t0" in b.meta
        ]
        if not anchors:
            return 0.0
        t = self.clock() if now is None else float(now)
        return max(t - min(anchors), 0.0)

    # -- dispatch side (single consumer: the engine loop) --------------

    def _place(self, req: ServeRequest) -> None:
        b = self.planner.add(
            req, req.sample.num_nodes, req.sample.num_edges
        )
        # The deadline anchors at the bin's OLDEST member: requests are
        # placed in arrival order, so the first placement stamps it.
        if "t0" not in b.meta:
            b.meta["t0"] = req.t_enqueue
        if b.graph_room == 0:
            self.planner.pop(b)
            self._ready.append(("full", b))
        for fb in self.planner.take_frozen():
            self._ready.append(("pressure", fb))

    def _earliest_expiry(self) -> Optional[Tuple[float, OpenBin]]:
        best = None
        for b in self.planner.open_bins:
            t = b.meta["t0"] + self.deadline_s
            if best is None or t < best[0]:
                best = (t, b)
        return best

    def next_bin(
        self, timeout: Optional[float] = None
    ) -> Optional[Tuple[str, OpenBin]]:
        """Block until a bin is dispatchable and return ``(reason,
        bin)``; reasons per the module docstring. ``timeout`` bounds
        the wait when no deadline is pending (None = wait for traffic
        indefinitely unless closed). Returns None when the wait ran
        out with nothing to dispatch — or, after ``close()``, when
        everything has drained (remaining bins flush as
        ``"flush"``)."""
        t_give_up = None if timeout is None else self.clock() + float(timeout)
        while True:
            # Pull whatever has arrived into the planner first: a
            # ready bin must reflect every request that beat it here.
            while True:
                try:
                    self._place(self._q.get_nowait())
                except queue.Empty:
                    break
            if self._ready:
                return self._ready.popleft()
            now = self.clock()
            expiry = self._earliest_expiry()
            if expiry is not None and expiry[0] <= now:
                self.planner.pop(expiry[1])
                return "deadline", expiry[1]
            if self._closed and self._q.empty():
                for b in self.planner.drain():
                    self._ready.append(("flush", b))
                if self._ready:
                    return self._ready.popleft()
                return None
            waits = [
                t
                for t in (
                    None if expiry is None else expiry[0],
                    t_give_up,
                )
                if t is not None
            ]
            try:
                # No pending deadline and no caller bound: poll at a
                # coarse 50ms so a concurrent close() stays responsive
                # (the engine always passes a timeout; this is the
                # bare-batcher fallback).
                req = self._q.get(
                    timeout=(
                        max(min(waits) - now, 0.0) if waits else 0.05
                    )
                )
            except queue.Empty:
                if t_give_up is not None and self.clock() >= t_give_up:
                    return None  # caller's wait bound wins
                continue
            self._place(req)

    def bin_spec(self, b: OpenBin) -> PackSpec:
        """The dispatched bin's budget: smallest fitted shape holding
        its totals — identical downshift arithmetic to the epoch
        packer, so serving compiles exactly the budget set."""
        return self.planner.assign_budget(
            b.tot_nodes, b.tot_edges, len(b.tags)
        )

    def bin_requests(self, b: OpenBin) -> List[ServeRequest]:
        """Members in arrival order (tag insertion order)."""
        return list(b.tags)
