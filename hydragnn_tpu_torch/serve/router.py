"""Routing front for the fleet serving tier.

Counterpart of ``hydragnn_tpu/serve/router.py``, ported line for line:
it is host logic. The ``Router`` sits between every frontend and the N
engine replicas: one ``submit`` picks a replica under a dispatch policy,
enforces the per-replica queue bound, and applies the deadline-class
degradation policy when the tier is overloaded. It owns no thread —
submit runs on the caller's thread and never blocks — and every mutation
it makes on a replica goes through the handle's own atomic
``submit_inner``, so a concurrent rollover swap can never catch a
request between generations.

**Dispatch policies.**

- ``least_loaded``: the live replica with the smallest queue depth
  (queued + open-bin requests), lowest index on ties.
- ``spec_affinity``: the request's smallest shareable pack budget picks
  a home replica (budget rank modulo live replicas), so a skewed size
  histogram lands big-budget requests on one replica whose bins fill
  with same-class co-tenants, instead of salting every replica's bins
  with occasional giants. Falls back to least-loaded when the home
  replica is saturated: affinity buys bin locality, never a parked
  request.

**Deadline classes and load shedding.** Requests carry a deadline class
(0 = best-effort batch, 1 = standard, 2 = interactive). Overload is read
per replica from its queue depth against ``queue_bound`` and from the
batcher's oldest open-bin deadline anchor (aged past twice the dispatch
deadline: bins expire faster than the engine drains them). The router
sheds lowest class first: pressure level 1 sheds class 0, level 2 (twice
the bound) class <= 1, level 3 (four times the bound) everything. Every
shed is counted and emitted as a ``shed`` row: the request handle comes
back marked ``shed`` with its reason, and ``shed_report()`` reconciles
submitted == routed + shed.

**Dead-replica re-route.** When the tier's health monitor declares a
replica dead, ``reroute`` recovers its unfinished requests and
re-submits them through the same policy; requests whose class budget
already expired inside the dead replica are shed as ``expired`` rather
than served uselessly late.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from hydragnn_tpu_torch.data.graph import GraphSample, PackSpec
from hydragnn_tpu_torch.utils import telemetry

# Deadline classes: higher =
# more latency-critical = shed later. The tuple order IS the shed
# order.
DEADLINE_CLASSES = {"batch": 0, "standard": 1, "interactive": 2}

ROUTER_POLICIES = ("least_loaded", "spec_affinity")


class FleetRequest:
    """One request as the ROUTER sees it. Unlike a ``ServeRequest``
    (pinned to one batcher for life), a fleet request survives its
    replica: a re-route after replica death re-submits the sample on a
    live replica and swaps ``inner`` to the new incarnation — the
    response surface (``result``/``latency_ms``) always proxies the
    one that actually served. ``shed`` requests never get a result but
    are never silent either: ``shed_reason`` says why, and the
    router's counters carry them."""

    __slots__ = (
        "sample",
        "fleet_id",
        "deadline_class",
        "t_submit",
        "replica",
        "inner",
        "shed",
        "shed_reason",
        "reroutes",
    )

    def __init__(
        self,
        sample: GraphSample,
        fleet_id: int,
        deadline_class: int,
        t_submit: float,
    ):
        self.sample = sample
        self.fleet_id = int(fleet_id)
        self.deadline_class = int(deadline_class)
        self.t_submit = float(t_submit)
        self.replica: Optional[int] = None
        self.inner = None  # ServeRequest on the current replica
        self.shed = False
        self.shed_reason: Optional[str] = None
        self.reroutes = 0

    @property
    def result(self):
        return None if self.inner is None else self.inner.result

    @property
    def latency_ms(self) -> Optional[float]:
        """End-to-end latency from the ROUTER's submit stamp — a
        re-routed request pays for its dead first replica too (that is
        the latency the client saw)."""
        if self.inner is None or self.inner.t_done is None:
            return None
        return round(1e3 * (self.inner.t_done - self.t_submit), 4)

    @property
    def done(self) -> bool:
        return self.shed or (
            self.inner is not None and self.inner.result is not None
        )


class Router:
    """Dispatch front over replica handles (module docstring).

    A replica handle is duck-typed (``ServingTier``'s ``ReplicaHandle``
    in production, fakes in tests): ``index``, ``alive``, ``qsize()``,
    ``oldest_anchor_age_s()``, ``deadline_s``, ``submit_inner(sample,
    deadline_class)`` (atomic vs rollover swap), ``track(fr)``,
    ``recover_pending()``.

    ``class_budgets_ms[c]`` is class c's end-to-end latency budget
    (None = best-effort, never expires); it only gates the EXPIRED
    shed on re-route — a request that already missed its budget inside
    a dead replica is shed, not served uselessly late.
    """

    def __init__(
        self,
        replicas: Sequence,
        budgets: Sequence[PackSpec],
        *,
        policy: str = "least_loaded",
        queue_bound: int = 64,
        class_budgets_ms: Sequence[Optional[float]] = (None, None, None),
        clock=time.monotonic,
        emit=None,
    ):
        if policy not in ROUTER_POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}; choose from "
                f"{ROUTER_POLICIES}"
            )
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("Router needs at least one replica")
        self.policy = policy
        self.queue_bound = max(1, int(queue_bound))
        # Budgets sorted biggest-first, matching PackPlanner's order,
        # so rank 0 = the big shape and the LAST fitting rank is the
        # smallest budget that holds a request.
        self._budgets = sorted(
            budgets,
            key=lambda b: (b.num_nodes, b.num_edges),
            reverse=True,
        )
        if not self._budgets:
            raise ValueError("Router needs at least one pack budget")
        self.class_budgets_ms = tuple(
            None if v is None else float(v) for v in class_budgets_ms
        )
        self.clock = clock
        self._emit_fn = emit if emit is not None else telemetry.emit
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self.submitted = 0
        self.routed = 0
        self.reroutes = 0
        self.sheds: Dict[Tuple[str, int], int] = {}

    # -- policy --------------------------------------------------------

    def _live(self) -> List:
        live = [r for r in self.replicas if r.alive]
        if not live:
            raise RuntimeError(
                "no live replicas — the whole tier is down "
                "(dead-replica re-route only covers partial failures); "
                "restart the tier"
            )
        return live

    def budget_rank(self, sample: GraphSample) -> int:
        """Rank of the smallest budget this request can SHARE (0 = the
        big shape) — the spec-affinity key. A graph qualifies for a
        budget only when it fits with room for co-tenants (at most
        half the budget's node/edge capacity): a giant that would
        monopolize every smaller budget is a big-budget request and
        ranks 0, so a skewed histogram concentrates big-budget bins on
        the big-budget home replica instead of salting every replica
        with occasional giants. Oversize requests rank 0 too; the
        batcher's own fits() check is the loud front door for those."""
        n, e = sample.num_nodes, sample.num_edges
        rank = 0
        for i, b in enumerate(self._budgets):
            if (
                b.fits(n, e, 1)
                and 2 * n <= b.num_nodes
                and 2 * e <= b.num_edges
            ):
                rank = i
        return rank

    def pressure(self, r) -> int:
        """One replica's overload level: 0 nominal; 1 when the queue
        depth reaches ``queue_bound`` OR the batcher's oldest open-bin
        anchor has aged past twice its dispatch deadline (the engine
        is behind its own deadline trigger); 2 at twice the bound; 3
        at four times (the hard wall — even interactive requests shed
        there rather than queue into certain deadline misses)."""
        depth = r.qsize()
        if depth >= 4 * self.queue_bound:
            return 3
        if depth >= 2 * self.queue_bound:
            return 2
        if depth >= self.queue_bound:
            return 1
        if r.oldest_anchor_age_s() > 2.0 * r.deadline_s:
            return 1
        return 0

    def _pick(self, sample: GraphSample, live: List):
        if self.policy == "spec_affinity":
            home = live[self.budget_rank(sample) % len(live)]
            if home.qsize() < self.queue_bound:
                return home
        return min(live, key=lambda r: (r.qsize(), r.index))

    # -- the request hot path ------------------------------------------

    def submit(
        self, sample: GraphSample, *, deadline_class: int = 1
    ) -> FleetRequest:
        """Route one request; returns its fleet handle. Never blocks:
        policy arithmetic + one atomic batcher put. Under overload the
        request may come back ``shed`` (counted, reasoned) instead of
        routed — the caller ALWAYS gets the handle back, silence is
        not an outcome."""
        fr = FleetRequest(
            sample, next(self._ids), deadline_class, self.clock()
        )
        with self._lock:
            self.submitted += 1
        live = self._live()
        r = self._pick(sample, live)
        if self.pressure(r) > fr.deadline_class:
            # The policy's choice is overloaded for this class — try
            # the globally least-loaded escape hatch before shedding
            # (affinity must degrade to balance, not to drops).
            alt = min(live, key=lambda x: (x.qsize(), x.index))
            if self.pressure(alt) > fr.deadline_class:
                return self._shed(fr, alt, "overload")
            r = alt
        self._route(fr, r)
        return fr

    def _route(self, fr: FleetRequest, r) -> None:
        fr.replica = r.index
        fr.inner = r.submit_inner(fr.sample, fr.deadline_class)
        r.track(fr)
        with self._lock:
            self.routed += 1

    def _shed(self, fr: FleetRequest, r, reason: str) -> FleetRequest:
        fr.shed = True
        fr.shed_reason = reason
        key = (reason, fr.deadline_class)
        with self._lock:
            self.sheds[key] = self.sheds.get(key, 0) + 1
        self._emit_fn(
            {
                "t": "shed",
                "reason": reason,
                "class": fr.deadline_class,
                "fleet_id": fr.fleet_id,
                "replica": None if r is None else r.index,
                "queue_depth": None if r is None else r.qsize(),
            }
        )
        return fr

    # -- failure handling ----------------------------------------------

    def class_budget_ms(self, deadline_class: int) -> Optional[float]:
        c = int(deadline_class)
        if 0 <= c < len(self.class_budgets_ms):
            return self.class_budgets_ms[c]
        return None

    def reroute(self, dead) -> dict:
        """Recover a dead replica's unfinished requests and re-route
        them through the normal policy path (their shed protections
        included). Requests whose class budget already expired in the
        corpse are shed as ``expired`` — serving them late would only
        push live requests' p99 up. Returns (and emits) the
        machine-readable ``reroute`` accounting row. The caller must
        have stopped the dead replica's dispatch loop first — recovery
        reads batcher state the loop owns when alive."""
        pending = dead.recover_pending()
        now = self.clock()
        moved = expired = 0
        for fr in pending:
            budget = self.class_budget_ms(fr.deadline_class)
            if budget is not None and 1e3 * (now - fr.t_submit) > budget:
                self._shed(fr, None, "expired")
                expired += 1
                continue
            fr.reroutes += 1
            live = [r for r in self.replicas if r.alive]
            if not live:
                self._shed(fr, None, "no_live_replica")
                continue
            self._route(fr, self._pick(fr.sample, live))
            moved += 1
        with self._lock:
            self.reroutes += moved
        row = {
            "t": "reroute",
            "from_replica": dead.index,
            "recovered": len(pending),
            "moved": moved,
            "shed_expired": expired,
        }
        self._emit_fn(row)
        return row

    # -- accounting ----------------------------------------------------

    def shed_report(self) -> dict:
        """Machine-readable shed/route accounting: ``submitted ==
        routed_first + shed_at_submit`` (re-routes and their expiry
        sheds are additive on top). The bench/drill gates read THIS,
        not log lines."""
        with self._lock:
            by_class: Dict[str, int] = {}
            by_reason: Dict[str, int] = {}
            for (reason, cls), n in self.sheds.items():
                by_reason[reason] = by_reason.get(reason, 0) + n
                by_class[str(cls)] = by_class.get(str(cls), 0) + n
            return {
                "submitted": self.submitted,
                "routed": self.routed,
                "routed_first": self.routed - self.reroutes,
                "reroutes": self.reroutes,
                "shed_total": sum(self.sheds.values()),
                "shed_by_class": by_class,
                "shed_by_reason": by_reason,
            }
