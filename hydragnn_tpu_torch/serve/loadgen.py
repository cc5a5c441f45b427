"""Load-generator benches for the serving subsystem.

Counterpart of ``hydragnn_tpu/serve/loadgen.py``. It synthesizes an
open-loop request stream whose graph-size histogram mimics a named
corpus (qm9: small organics, ~18 nodes; zinc: drug-like, ~23 heavy
atoms; zinc_skew: zinc with a tail of giants), the same graphs bit for
bit as the JAX package's for the same (histogram, seed), drives it
through a ``DynamicBatcher`` + ``ServingEngine`` pair
(``run_load_bench``) or a ``ServingTier`` of replicas
(``run_fleet_bench``), and reports the numbers the tail-latency contract
is judged by: p50/p99 request latency, graphs/s, slot waste. Gates of
the load bench:

- ``recompiles``: no executable warmed after warm-up. The JAX package
  counts XLA compilations; the port counts CUDA-graph captures on a card
  (``StepGraphs.captures``) and warmed shapes on the CPU
  (``ServingEngine.warm_runs``). The gate keeps its name so reports
  compare;
- ``tail``: p99 latency <= deadline + 3x the worst observed bin service
  time + a scheduling slack;
- ``keeps_up``: the engine's busy window does not stretch the offered
  stream duration by more than 30% + slack;
- ``complete``: every submitted request came back with a response.

The fleet bench's gates are in ``run_fleet_bench``. Run directly
(``python -m hydragnn_tpu_torch.serve.loadgen --json``; ``--fleet N``
for the tier, ``--kill R`` for the dead-replica drill, ``--device cpu``
for the CPU plain path).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import zlib
from typing import List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample

# Size-histogram anchors: (node mean, node std, node lo, node hi,
# edges-per-node). qm9/zinc node statistics follow the public corpus
# descriptions (qm9 <= 29 atoms incl. H; zinc drug-like ~23 heavy
# atoms); edges-per-node ~2.1 matches bond-graph degree after
# symmetrization.
_HISTOGRAMS = {
    "qm9": (18.0, 3.0, 4, 29, 2.1),
    "zinc": (23.0, 4.5, 8, 38, 2.2),
    # Heavy-tailed zinc: the same drug-like body, but a slice of
    # requests are 2-3x giants (macrocycles / fragment dimers): the mix
    # the fleet router's spec-affinity policy exists for.
    "zinc_skew": (23.0, 4.5, 8, 104, 2.2),
}

# Heavy-tail mixture for *_skew histograms: (tail fraction, node-count
# multiplier lo, hi) applied over the body mean.
_SKEW_TAILS = {
    "zinc_skew": (0.12, 2.0, 3.5),
}


def synthetic_request_samples(
    histogram: str = "qm9",
    n_requests: int = 128,
    *,
    seed: int = 0,
    with_node_targets: bool = False,
    class_mix: Optional[Sequence[float]] = None,
) -> List[GraphSample]:
    """Deterministic GraphSamples whose size distribution follows the
    named corpus histogram: the request payloads and the offline fitting
    corpus (serving budgets are fitted from sizes alone). ``*_skew``
    histograms mix in a heavy tail of giants (module constants).

    ``class_mix`` = (p_batch, p_standard, p_interactive) stamps each
    sample with a ``deadline_class`` attribute drawn from that mix; None
    stamps everything standard (class 1). The class draw comes after the
    size and content draws, so a (histogram, seed) stream is the same
    whatever the mix."""
    if histogram not in _HISTOGRAMS:
        raise ValueError(
            f"unknown histogram {histogram!r}; choose from "
            f"{sorted(_HISTOGRAMS)}"
        )
    mean, std, lo, hi, epn = _HISTOGRAMS[histogram]
    tail = _SKEW_TAILS.get(histogram)
    # crc32, not hash(): str hashing is randomized per process, and
    # the stream must reproduce across invocations.
    rng = np.random.default_rng(
        (seed, zlib.crc32(histogram.encode()) & 0xFFFF)
    )
    out = []
    for _ in range(int(n_requests)):
        if tail is not None and rng.random() < tail[0]:
            n = int(
                np.clip(
                    round(rng.uniform(tail[1], tail[2]) * mean),
                    lo,
                    hi,
                )
            )
        else:
            n = int(np.clip(round(rng.normal(mean, std)), lo, hi))
        e = max(int(round(n * epn + rng.normal(0.0, 2.0))), 1)
        senders = rng.integers(0, n, e)
        receivers = (senders + 1 + rng.integers(0, max(n - 1, 1), e)) % n
        s = GraphSample(
            x=rng.normal(size=(n, 1)).astype(np.float32),
            pos=rng.uniform(0, 4.0, size=(n, 3)).astype(np.float32),
            edge_index=np.stack([senders, receivers]).astype(np.int64),
            y_graph=np.array([rng.normal()], dtype=np.float32),
        )
        if with_node_targets:
            s.y_node = rng.normal(size=(n, 1)).astype(np.float32)
        out.append(s)
    if class_mix is not None:
        p = np.asarray(class_mix, dtype=np.float64)
        if p.shape != (3,) or (p < 0).any() or p.sum() <= 0:
            raise ValueError(
                "class_mix must be 3 non-negative weights "
                "(batch, standard, interactive)"
            )
        classes = rng.choice(3, size=len(out), p=p / p.sum())
        for s, c in zip(out, classes):
            s.deadline_class = int(c)
    else:
        for s in out:
            s.deadline_class = 1
    return out


def _tiny_serving_model(device=None):
    """The JAX package's bench model: SchNet, hidden 16, 2 layers, 16
    Gaussians, one graph head; random weights from seed 0. Returns
    (model, cfg, state), state None (the model's own weights)."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.models.spec import BranchSpec, HeadSpec, ModelConfig

    cfg = ModelConfig(
        mpnn_type="SchNet",
        input_dim=1,
        hidden_dim=16,
        num_conv_layers=2,
        heads=(HeadSpec("e", "graph", 1),),
        graph_branches=(BranchSpec(),),
        node_branches=(),
        task_weights=(1.0,),
        radius=3.0,
        num_gaussians=16,
        num_filters=16,
    )
    return create_model(cfg, device, seed=0), cfg, None


def _warm_count(engine) -> int:
    """Executables warmed so far: graphs captured on a card, warmed
    shapes on the CPU (the ``recompiles`` gate's count)."""
    if engine.graphs is not None:
        return engine.graphs.captures
    return engine.warm_runs


def run_load_bench(
    *,
    histogram: str = "qm9",
    n_requests: int = 96,
    deadline_ms: float = 30.0,
    rate_hz: Optional[float] = None,
    batch_size: int = 8,
    max_open_bins: int = 3,
    seed: int = 0,
    model_bits=None,
    class_mix: Optional[Sequence[float]] = None,
    device=None,
) -> dict:
    """One full load-bench pass; returns the report dict (module
    docstring documents the gates). ``rate_hz`` None = calibrate the
    offered rate to ~2x the single-bin service rate measured at
    warm-up, so the stream exercises real batching pressure without
    unbounded queue growth. ``model_bits`` = (model, cfg, state)
    reuses a caller's model (``state`` a ``state_dict`` or None).
    ``class_mix`` stamps per-request deadline classes (a bare engine
    batches all classes alike; carried so the single-engine bench
    exercises the stream shape the fleet bench sheds on). ``device``
    None means ``"cuda"``."""
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
    from hydragnn_tpu_torch.serve.engine import (
        ServingEngine,
        ServingSettings,
        fit_serving_budgets,
    )

    samples = synthetic_request_samples(
        histogram, n_requests, seed=seed, class_mix=class_mix
    )
    ns, es = dataset_size_arrays(samples)
    settings = ServingSettings(
        enabled=True,
        deadline_ms=float(deadline_ms),
        max_open_bins=int(max_open_bins),
        batch_size=int(batch_size),
    )
    budgets = fit_serving_budgets(ns, es, settings, seed=seed)
    if model_bits is None:
        model, cfg, state = _tiny_serving_model(device)
    else:
        model, cfg, state = model_bits

    t0 = time.perf_counter()
    engine = ServingEngine(
        model,
        cfg,
        state,
        budgets,
        example=samples[0],
        settings=settings,
        device=device,
    )
    warm_s = time.perf_counter() - t0

    # From here on, any executable warmed (a capture on a card) is a
    # serving-path shape leak.
    warm0 = _warm_count(engine)
    post_warmup = 0
    batcher = None
    try:
        # Calibrate the offered rate off the warm executables: one
        # timed bin of the stream's first requests.
        probe = DynamicBatcher(
            budgets, deadline_ms=1e6, max_open_bins=max_open_bins
        )
        for s in samples[: max(batch_size, 4)]:
            probe.submit(s)
        probe.close()
        t0 = time.perf_counter()
        engine.process(probe, timeout=0.02)
        probe_s = max(time.perf_counter() - t0, 1e-4)
        probe_graphs = max(batch_size, 4)
        if rate_hz is None:
            rate_hz = 2.0 * probe_graphs / probe_s
        gap_s = 1.0 / max(rate_hz, 1e-6)

        # The calibration probe's records must not pollute the
        # measured stream's rollup.
        engine.reset_stats()

        batcher = DynamicBatcher(
            budgets,
            deadline_ms=deadline_ms,
            max_open_bins=max_open_bins,
        )
        reqs: List = []

        def _drive():
            for s in samples:
                reqs.append(
                    batcher.submit(
                        s,
                        deadline_class=getattr(
                            s, "deadline_class", 1
                        ),
                    )
                )
                time.sleep(gap_s)
            batcher.close()

        t_stream0 = time.perf_counter()
        feeder = threading.Thread(target=_drive, daemon=True)
        feeder.start()
        engine.process(batcher, timeout=max(deadline_ms / 1e3, 0.02))
        feeder.join(timeout=30)
        wall_s = time.perf_counter() - t_stream0

        rollup = engine.rollup(emit=True)
        post_warmup = _warm_count(engine) - warm0
        offered_s = n_requests * gap_s
        service_ms = [
            1e3 * (r["t_done"] - r["t_start"])
            for r in engine._records
        ]
        max_service_ms = max(service_ms) if service_ms else 0.0
        tail_budget_ms = deadline_ms + 3.0 * max_service_ms + 250.0
        gates = {
            "recompiles": post_warmup == 0,
            "tail": (
                rollup.get("p99_ms", float("inf")) <= tail_budget_ms
            ),
            "keeps_up": wall_s <= offered_s * 1.3 + 1.0,
            # Completeness: percentiles over a stream that silently
            # dropped responses would gate a lie.
            "complete": (
                len(reqs) == n_requests
                and all(r.result is not None for r in reqs)
            ),
        }
    finally:
        # A failed gate, a mid-stream crash or a raised assertion must
        # not leak a warm engine or an open batcher.
        if batcher is not None:
            batcher.close()
        engine.close()
    report = {
        "histogram": histogram,
        "requests": int(n_requests),
        "class_mix": None if class_mix is None else list(class_mix),
        "deadline_ms": float(deadline_ms),
        "offered_rate_hz": round(float(rate_hz), 2),
        "budgets": [
            (b.num_nodes, b.num_edges, b.num_graphs) for b in budgets
        ],
        "warmup_s": round(warm_s, 3),
        "wall_s": round(wall_s, 3),
        "offered_s": round(offered_s, 3),
        "max_service_ms": round(max_service_ms, 3),
        "tail_budget_ms": round(tail_budget_ms, 3),
        "post_warmup_compiles": post_warmup,
        "p50_ms": rollup.get("p50_ms"),
        "p99_ms": rollup.get("p99_ms"),
        "graphs_per_sec": rollup.get("graphs_per_sec"),
        "node_fill": rollup.get("node_fill"),
        "edge_fill": rollup.get("edge_fill"),
        "slot_waste": rollup.get("slot_waste"),
        "dispatch_reasons": rollup.get("dispatch_reasons"),
        "gates": gates,
        "ok": all(gates.values()),
    }
    return report


def _percentile_ms(vals: List[float], q: float) -> Optional[float]:
    if not vals:
        return None
    return round(float(np.percentile(np.asarray(vals), q)), 3)


def run_fleet_bench(
    *,
    histogram: str = "zinc_skew",
    n_requests: int = 120,
    deadline_ms: float = 40.0,
    rate_hz: Optional[float] = None,
    batch_size: int = 8,
    max_open_bins: int = 3,
    replicas: int = 2,
    policy: str = "spec_affinity",
    queue_bound: int = 64,
    seed: int = 0,
    kill_replica: Optional[int] = None,
    kill_after_frac: float = 0.4,
    class_mix: Sequence[float] = (0.25, 0.5, 0.25),
    class_budgets_ms: Sequence[Optional[float]] = (250.0, None, None),
    heartbeat_interval_s: float = 0.1,
    heartbeat_timeout_s: float = 0.5,
    telemetry_base: Optional[str] = None,
    model_bits=None,
    device=None,
) -> dict:
    """Fleet loadgen pass: a skewed,
    class-mixed open-loop stream through a ``ServingTier`` of
    ``replicas`` engine replicas. With ``kill_replica`` set, that
    replica is MURDERED mid-stream (after ``kill_after_frac`` of the
    stream) — the drill shape: heartbeat-gap detection, re-route, and
    the gates prove p99 recovers with zero dropped in-deadline
    requests.

    Gates:

    - ``recompiles``: no executable warmed after warm-up across ALL
      replicas (every replica warms the same budget set, so a re-route
      never captures);
    - ``complete_in_deadline``: every class >= 1 (standard +
      interactive) request came back served — sheds are only ever
      best-effort class 0 (the degradation policy's contract) or
      budget-``expired`` class 0 on re-route;
    - ``tail_recovered``: p99 over the RECOVERY window (requests
      submitted after the kill + detection settle) is within the same
      tail budget as the steady state — the tier healed, not limped;
    - ``detected`` (kill runs only): the health monitor declared the
      murdered replica dead and recovered its pending requests.
    """
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve.engine import (
        ServingSettings,
        fit_serving_budgets,
    )
    from hydragnn_tpu_torch.serve.fleet import FleetSettings, ServingTier

    samples = synthetic_request_samples(
        histogram, n_requests, seed=seed, class_mix=class_mix
    )
    ns, es = dataset_size_arrays(samples)
    settings = ServingSettings(
        enabled=True,
        deadline_ms=float(deadline_ms),
        max_open_bins=int(max_open_bins),
        batch_size=int(batch_size),
    )
    budgets = fit_serving_budgets(ns, es, settings, seed=seed)
    if model_bits is None:
        model, cfg, state = _tiny_serving_model(device)
    else:
        model, cfg, state = model_bits
    fleet = FleetSettings(
        replicas=int(replicas),
        policy=policy,
        queue_bound=int(queue_bound),
        heartbeat_interval_s=float(heartbeat_interval_s),
        heartbeat_timeout_s=float(heartbeat_timeout_s),
        class_budgets_ms=tuple(class_budgets_ms),
    )

    t0 = time.perf_counter()
    tier = ServingTier(
        model,
        cfg,
        state,
        budgets,
        example=samples[0],
        settings=settings,
        fleet=fleet,
        telemetry_base=telemetry_base,
        device=device,
    )
    warm_s = time.perf_counter() - t0
    warm0 = sum(_warm_count(h.engine) for h in tier.replicas)
    post_warmup = 0
    try:
        # Rate calibration through the live tier: a small probe burst,
        # timed to completion (deadline-dispatch included, so the
        # derived rate is conservative), then per-replica stat reset
        # so the probe never pollutes the measured rollups.
        n_probe = max(batch_size, 4)
        probe = [tier.submit(s) for s in samples[:n_probe]]
        t0 = time.perf_counter()
        t_probe_limit = t0 + 30.0
        while (
            not all(r.done for r in probe)
            and time.perf_counter() < t_probe_limit
        ):
            time.sleep(0.005)
        probe_s = max(time.perf_counter() - t0, 1e-4)
        if rate_hz is None:
            # Offered rate from the probe's BIN cost, not its batch
            # throughput: steady state dispatches deadline-triggered,
            # sparsely-filled bins, so the worst per-request cost is a
            # whole bin service — a burst-derived rate overloads the
            # tier the moment bins stop filling. Target ~50% of that
            # worst-case capacity; replicas are threads sharing one
            # host and one device, so replica count buys failure
            # isolation, not rate (the min-post stretch below keeps
            # enough post-kill stream on fast hosts regardless).
            bin_cost_s = max(
                probe_s - settings.deadline_ms / 1e3, 5e-3
            )
            rate_hz = 0.5 / bin_cost_s
        gap_s = 1.0 / max(rate_hz, 1e-6)
        reqs: List = []
        kill_at = (
            None
            if kill_replica is None
            else max(int(kill_after_frac * n_requests), 1)
        )
        settle_s = heartbeat_timeout_s + 2.0 * max(
            heartbeat_interval_s, 0.05
        )
        if kill_at is not None:
            # The recovery gate needs requests submitted AFTER the
            # detection settle — stretch the stream so the post-kill
            # leg outlives it (a calibrated burst on a small drill
            # stream can otherwise finish inside the outage window).
            min_post_s = settle_s + 1.0
            gap_s = max(
                gap_s, min_post_s / max(n_requests - kill_at, 1)
            )
            rate_hz = 1.0 / gap_s
        for h in tier.replicas:
            h.engine.reset_stats()

        t_kill = [None]

        def _drive():
            for i, s in enumerate(samples):
                if kill_at is not None and i == kill_at:
                    t_kill[0] = time.monotonic()
                    tier.kill_replica(kill_replica)
                reqs.append(
                    tier.submit(s, deadline_class=s.deadline_class)
                )
                time.sleep(gap_s)

        t_stream0 = time.perf_counter()
        feeder = threading.Thread(target=_drive, daemon=True)
        feeder.start()
        feeder.join(timeout=120)
        # Open bins flush on their own deadline trigger; wait for the
        # stream to fully resolve (served or loudly shed).
        t_limit = time.perf_counter() + 30.0
        while (
            not all(r.done for r in reqs)
            and time.perf_counter() < t_limit
        ):
            time.sleep(0.005)
        wall_s = time.perf_counter() - t_stream0

        report_tier = tier.report()
        post_warmup = (
            sum(_warm_count(h.engine) for h in tier.replicas) - warm0
        )
        shed = report_tier["router"]
        lat_all = [
            r.latency_ms for r in reqs if r.latency_ms is not None
        ]
        # Recovery window: requests submitted after the health monitor
        # declared the corpse dead (exact boundary when available —
        # they never touched the dead replica), else after the kill
        # plus the detection settle.
        if t_kill[0] is not None:
            t_dead = (
                tier.replicas[kill_replica].t_dead
                if kill_replica is not None
                else None
            )
            t_rec = (
                t_dead
                if t_dead is not None
                else t_kill[0] + settle_s
            )
            lat_recovery = [
                r.latency_ms
                for r in reqs
                if r.latency_ms is not None and r.t_submit > t_rec
            ]
            if not lat_recovery and t_dead is not None:
                # Detection landed after the last submit (a starved
                # monitor on a saturated host): judge recovery from
                # the settle boundary rather than an empty window.
                t_rec = t_kill[0] + settle_s
                lat_recovery = [
                    r.latency_ms
                    for r in reqs
                    if r.latency_ms is not None
                    and r.t_submit > t_rec
                ]
        else:
            lat_recovery = lat_all
        service_ms = [
            1e3 * (rec["t_done"] - rec["t_start"])
            for h in tier.replicas
            if h.engine is not None
            for rec in h.engine._records
        ]
        max_service_ms = max(service_ms) if service_ms else 0.0
        tail_budget_ms = deadline_ms + 3.0 * max_service_ms + 250.0
        p99_recovery = _percentile_ms(lat_recovery, 99)
        shed_hi = sum(
            n
            for c, n in shed["shed_by_class"].items()
            if int(c) >= 1
        )
        served_hi = [
            r
            for r in reqs
            if r.deadline_class >= 1 and not r.shed
        ]
        gates = {
            "recompiles": post_warmup == 0,
            "complete_in_deadline": (
                shed_hi == 0
                and all(r.result is not None for r in served_hi)
                and len(served_hi)
                == sum(1 for r in reqs if r.deadline_class >= 1)
            ),
            "tail_recovered": (
                p99_recovery is not None
                and p99_recovery <= tail_budget_ms
            ),
        }
        if kill_replica is not None:
            gates["detected"] = (
                not tier.replicas[kill_replica].alive
            )
    finally:
        # The tier (threads, engines, telemetry shards) never outlives
        # the bench, assertions failed or not.
        tier.close()
    return {
        "histogram": histogram,
        "requests": int(n_requests),
        "replicas": int(replicas),
        "policy": policy,
        "deadline_ms": float(deadline_ms),
        "offered_rate_hz": round(float(rate_hz), 2),
        "class_mix": list(class_mix),
        "kill_replica": kill_replica,
        "warmup_s": round(warm_s, 3),
        "wall_s": round(wall_s, 3),
        "max_service_ms": round(max_service_ms, 3),
        "tail_budget_ms": round(tail_budget_ms, 3),
        "post_warmup_compiles": post_warmup,
        "p50_ms": _percentile_ms(lat_all, 50),
        "p99_ms": _percentile_ms(lat_all, 99),
        "p99_recovery_ms": p99_recovery,
        "router": shed,
        "tier": report_tier,
        "gates": gates,
        "ok": all(gates.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hydragnn_tpu_torch.serve.loadgen", description=__doc__
    )
    ap.add_argument(
        "--histogram", default="qm9", choices=sorted(_HISTOGRAMS)
    )
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--deadline-ms", type=float, default=30.0)
    ap.add_argument(
        "--rate-hz",
        type=float,
        default=None,
        help="offered request rate (default: 2x calibrated service rate)",
    )
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument(
        "--fleet",
        type=int,
        default=0,
        metavar="N",
        help="run the FLEET bench through a ServingTier of N replicas "
        "(0 = single-engine bench)",
    )
    ap.add_argument(
        "--policy",
        default="spec_affinity",
        choices=("least_loaded", "spec_affinity"),
        help="fleet routing policy (with --fleet)",
    )
    ap.add_argument(
        "--kill",
        type=int,
        default=None,
        metavar="R",
        help="murder replica R mid-stream (with --fleet): the "
        "detection/re-route/p99-recovery drill",
    )
    ap.add_argument(
        "--telemetry",
        default=None,
        metavar="PATH",
        help="telemetry.jsonl base path for per-replica shards "
        "(with --fleet); inspect with `graftboard fleet <dir>`",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="device to serve on (default cuda; cpu runs the plain path)",
    )
    args = ap.parse_args(argv)
    if args.fleet > 0:
        report = run_fleet_bench(
            histogram=args.histogram,
            n_requests=args.requests,
            deadline_ms=args.deadline_ms,
            rate_hz=args.rate_hz,
            batch_size=args.batch_size,
            seed=args.seed,
            replicas=args.fleet,
            policy=args.policy,
            kill_replica=args.kill,
            telemetry_base=args.telemetry,
            device=args.device,
        )
    else:
        report = run_load_bench(
            histogram=args.histogram,
            n_requests=args.requests,
            deadline_ms=args.deadline_ms,
            rate_hz=args.rate_hz,
            batch_size=args.batch_size,
            seed=args.seed,
            device=args.device,
        )
    if args.as_json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
