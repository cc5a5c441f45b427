"""The port's fleet serving tier against the JAX package.

- the router cases of tests/test_fleet_serving.py over fake replica
  handles, each run on the JAX package's ``Router`` and on the port's
  (host logic, ported line for line: both must give the same routes,
  pressure levels, sheds, rows and accounting);
- the batcher's oldest-anchor gauge and ``fleet_settings``;
- ``synthetic_request_samples`` with ``class_mix``, ``zinc_skew`` and
  node targets equal to the JAX package's bit for bit;
- the telemetry stream core: header, rows, heartbeats and the close row,
  and ``tools/graftboard.py``'s fleet view of port shards (a replica
  abandoned without a close row detected dead, its re-route covering
  it);
- a two-replica tier on the CPU plain path: a killed replica detected,
  its requests re-routed, no in-deadline request dropped; a rollover
  refused for a NaN snapshot (and for a warm-up crash) leaving the old
  outputs bit for bit; a clean rollover.

Small sizes: SchNet hidden 16, two conv layers, on ~24 requests.
"""

import threading
import time
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

from hydragnn_tpu.data.graph import PackSpec as JPackSpec
from hydragnn_tpu.serve import loadgen as jloadgen
from hydragnn_tpu.serve import router as jrouter


@pytest.fixture(scope="module")
def port():
    """torch and the port's serving modules, imported when this file runs
    rather than at collection."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch.data import graph, padschedule
    from hydragnn_tpu_torch.serve import admission, batcher, engine, fleet, loadgen, router
    from hydragnn_tpu_torch.utils import telemetry

    return types.SimpleNamespace(
        torch=torch, graph=graph, padschedule=padschedule, admission=admission,
        batcher=batcher, engine=engine, fleet=fleet, loadgen=loadgen, router=router,
        telemetry=telemetry,
    )


# ----------------------------------------------------------------------
# Router over fake replicas, on both packages' Router
# ----------------------------------------------------------------------


class _FakeInner:
    def __init__(self):
        self.result = None
        self.t_done = None


class _FakeReplica:
    def __init__(self, index, depth=0, anchor_age=0.0, deadline_s=0.04):
        self.index = index
        self.alive = True
        self.depth = depth
        self.anchor_age = anchor_age
        self.deadline_s = deadline_s
        self.routed = []
        self.tracked = []
        self.pending = []

    def qsize(self):
        return self.depth

    def oldest_anchor_age_s(self):
        return self.anchor_age

    def submit_inner(self, sample, deadline_class):
        self.routed.append((sample, deadline_class))
        self.depth += 1
        return _FakeInner()

    def track(self, fr):
        self.tracked.append(fr)

    def recover_pending(self):
        out, self.pending = self.pending, []
        return out


def _sample(n=20, e=40):
    return types.SimpleNamespace(num_nodes=n, num_edges=e)


BUDGETS = ((208, 456, 13), (104, 224, 7))


def _impl(port, which):
    """(router module, PackSpec class) of the JAX package or the port."""
    if which == "jax":
        return jrouter, JPackSpec
    return port.router, port.graph.PackSpec


def _router(port, which, replicas, **kw):
    mod, spec = _impl(port, which)
    rows = []
    r = mod.Router(replicas, [spec(*b) for b in BUDGETS], emit=rows.append, **kw)
    return r, rows


IMPLS = ["jax", "port"]


@pytest.mark.parametrize("which", IMPLS)
def test_router_least_loaded_min_queue_lowest_index_tie(port, which):
    reps = [_FakeReplica(0, depth=3), _FakeReplica(1, depth=1), _FakeReplica(2, depth=1)]
    router, _ = _router(port, which, reps, policy="least_loaded")
    fr = router.submit(_sample())
    assert fr.replica == 1 and not fr.shed
    assert reps[1].routed and reps[1].tracked == [fr]


@pytest.mark.parametrize("which", IMPLS)
def test_router_budget_rank_half_capacity_share_rule(port, which):
    router, _ = _router(port, which, [_FakeReplica(0)], policy="spec_affinity")
    assert router.budget_rank(_sample(20, 40)) == 1
    assert router.budget_rank(_sample(60, 150)) == 0
    assert router.budget_rank(_sample(52, 115)) == 0
    assert router.budget_rank(_sample(500, 900)) == 0


@pytest.mark.parametrize("which", IMPLS)
def test_router_spec_affinity_homes_then_falls_back(port, which):
    reps = [_FakeReplica(0), _FakeReplica(1)]
    router, _ = _router(port, which, reps, policy="spec_affinity", queue_bound=4)
    small, big = _sample(20, 40), _sample(60, 150)
    assert router.submit(small).replica == 1
    assert router.submit(big).replica == 0
    reps[1].depth = 4
    fr = router.submit(small)
    assert fr.replica == 0 and not fr.shed


@pytest.mark.parametrize("which", IMPLS)
def test_router_pressure_levels_depth_and_anchor(port, which):
    r = _FakeReplica(0)
    router, _ = _router(port, which, [r], queue_bound=8)
    levels = []
    for depth in (0, 8, 16, 32):
        r.depth = depth
        levels.append(router.pressure(r))
    assert levels == [0, 1, 2, 3]
    r.depth = 0
    r.anchor_age = 0.09  # > 2 * 0.04
    assert router.pressure(r) == 1


@pytest.mark.parametrize("which", IMPLS)
def test_router_sheds_lowest_class_first_counts_and_rows(port, which):
    r = _FakeReplica(0, depth=8)
    router, rows = _router(port, which, [r], queue_bound=8)
    shed0 = router.submit(_sample(), deadline_class=0)
    kept1 = router.submit(_sample(), deadline_class=1)
    assert shed0.shed and shed0.shed_reason == "overload"
    assert shed0.result is None and shed0.done
    assert not kept1.shed
    r.depth = 16
    shed1 = router.submit(_sample(), deadline_class=1)
    kept2 = router.submit(_sample(), deadline_class=2)
    assert shed1.shed and not kept2.shed
    r.depth = 32
    assert router.submit(_sample(), deadline_class=2).shed
    rep = router.shed_report()
    assert rep["submitted"] == 5 and rep["shed_total"] == 3
    assert rep["submitted"] == rep["routed_first"] + rep["shed_total"]
    assert rep["shed_by_reason"] == {"overload": 3}
    assert rep["shed_by_class"] == {"0": 1, "1": 1, "2": 1}
    shed_rows = [x for x in rows if x["t"] == "shed"]
    assert len(shed_rows) == 3
    assert set(shed_rows[0]) == {"t", "reason", "class", "fleet_id", "replica", "queue_depth"}


@pytest.mark.parametrize("which", IMPLS)
def test_router_shed_escape_hatch_prefers_least_loaded_alt(port, which):
    reps = [_FakeReplica(0), _FakeReplica(1, anchor_age=0.09)]
    router, rows = _router(port, which, reps, policy="spec_affinity", queue_bound=8)
    fr = router.submit(_sample(20, 40), deadline_class=0)
    assert not fr.shed and fr.replica == 0
    assert rows == []


@pytest.mark.parametrize("which", IMPLS)
def test_router_reroute_moves_pending_and_sheds_expired(port, which):
    mod, _ = _impl(port, which)
    clk = [100.0]
    dead = _FakeReplica(0)
    dead.alive = False
    live = _FakeReplica(1)
    router, rows = _router(
        port, which, [dead, live], class_budgets_ms=(None, None, 50.0),
        clock=lambda: clk[0],
    )
    stale = mod.FleetRequest(_sample(), 0, 2, t_submit=99.0)
    fresh = mod.FleetRequest(_sample(), 1, 0, t_submit=99.99)
    dead.pending = [stale, fresh]
    row = router.reroute(dead)
    assert row == {"t": "reroute", "from_replica": 0, "recovered": 2, "moved": 1,
                   "shed_expired": 1}
    assert stale.shed and stale.shed_reason == "expired"
    assert fresh.replica == 1 and fresh.reroutes == 1
    assert router.shed_report()["reroutes"] == 1
    live.alive = False
    dead.pending = [mod.FleetRequest(_sample(), 2, 0, t_submit=clk[0])]
    assert router.reroute(dead)["moved"] == 0
    assert router.shed_report()["shed_by_reason"]["no_live_replica"] == 1


@pytest.mark.parametrize("which", IMPLS)
def test_router_no_live_replicas_raises_and_bad_policy_rejected(port, which):
    mod, spec = _impl(port, which)
    r = _FakeReplica(0)
    r.alive = False
    router, _ = _router(port, which, [r])
    with pytest.raises(RuntimeError, match="no live replicas"):
        router.submit(_sample())
    with pytest.raises(ValueError, match="unknown routing policy"):
        mod.Router([_FakeReplica(0)], [spec(*BUDGETS[0])], policy="round_robin")
    assert mod.DEADLINE_CLASSES == {"batch": 0, "standard": 1, "interactive": 2}
    assert mod.ROUTER_POLICIES == ("least_loaded", "spec_affinity")


def test_batcher_oldest_anchor_age_reads_oldest_open_bin(port):
    budgets = [port.graph.PackSpec(*b) for b in BUDGETS]
    clk = [0.0]
    bat = port.batcher.DynamicBatcher(budgets, deadline_ms=1e6, clock=lambda: clk[0])
    assert bat.oldest_anchor_age_s() == 0.0
    samples = port.loadgen.synthetic_request_samples("qm9", 3, seed=0)
    req = bat.submit(samples[0], deadline_class=2)
    assert req.deadline_class == 2
    clk[0] = 0.5
    bat.submit(samples[1])
    assert bat.next_bin(timeout=0.0) is None  # pulls both into open bins
    clk[0] = 2.0
    assert bat.oldest_anchor_age_s() == pytest.approx(2.0)
    assert bat.oldest_anchor_age_s(now=3.0) == pytest.approx(3.0)


def test_fleet_settings_resolution(port):
    fs = port.fleet.fleet_settings({})
    assert fs == port.fleet.FleetSettings()
    fs = port.fleet.fleet_settings({"Serving": {"Fleet": {
        "replicas": 3, "policy": "spec_affinity", "queue_bound": 16,
        "class_budgets_ms": [250, None, None]}}})
    assert (fs.replicas, fs.policy, fs.queue_bound) == (3, "spec_affinity", 16)
    assert fs.class_budgets_ms == (250.0, None, None)
    with pytest.raises(ValueError, match="policy"):
        port.fleet.fleet_settings({"Serving": {"Fleet": {"policy": "random"}}})


# ----------------------------------------------------------------------
# The request stream, bit for bit
# ----------------------------------------------------------------------


@pytest.mark.parametrize("histogram,class_mix,node_targets", [
    ("zinc_skew", (0.25, 0.5, 0.25), False),
    ("qm9", None, True),
    ("zinc", (0.0, 0.3, 0.7), True),
])
def test_request_stream_matches_jax(port, histogram, class_mix, node_targets):
    kw = dict(seed=5, class_mix=class_mix, with_node_targets=node_targets)
    js = jloadgen.synthetic_request_samples(histogram, 48, **kw)
    ts = port.loadgen.synthetic_request_samples(histogram, 48, **kw)
    assert len(js) == len(ts) == 48
    for a, b in zip(js, ts):
        for f in ("x", "pos", "edge_index", "y_graph", "y_node"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(np.asarray(x), y)
        assert a.deadline_class == b.deadline_class
    with pytest.raises(ValueError, match="class_mix"):
        port.loadgen.synthetic_request_samples("qm9", 4, class_mix=(1.0, -1.0, 0.0))


# ----------------------------------------------------------------------
# Telemetry stream core and graftboard's fleet view
# ----------------------------------------------------------------------


def _graftboard():
    import tools.graftboard as gb

    return gb


def test_telemetry_stream_rows_heartbeats_and_close(port, tmp_path):
    tel = port.telemetry
    base = str(tmp_path / "telemetry.jsonl")
    assert tel.shard_path(base, 0) == base
    assert tel.shard_path(base, 2) == str(tmp_path / "telemetry.proc2.jsonl")
    s = tel.TelemetryStream(base, heartbeat_interval_s=0.02, process_index=0,
                            meta={"role": "test"})
    tel.install(s)
    try:
        assert tel.active() and tel.get() is s
        tel.note_phase("serve")
        time.sleep(0.08)
        assert tel.emit({"t": "serve", "graphs": 2, "v": np.float32(1.5)})
    finally:
        tel.install(None)
    s.close()
    assert not s.emit({"t": "late"})
    rows, skipped = _graftboard().read_stream(base)
    assert skipped == 0
    assert rows[0]["t"] == "header" and rows[0]["role"] == "test"
    assert rows[0]["schema"] == tel.SCHEMA_VERSION and rows[0]["process_index"] == 0
    assert rows[-1]["t"] == "close" and rows[-1]["emitted"] == len(rows)
    beats = [r for r in rows if r["t"] == "heartbeat"]
    assert len(beats) >= 2 and [b["seq"] for b in beats] == list(range(1, len(beats) + 1))
    assert any(b["phase"] == "serve" and b["phase_age_s"] >= 0.0 for b in beats)
    serve = [r for r in rows if r["t"] == "serve"]
    assert serve == [{"t": "serve", "graphs": 2, "v": 1.5, "process_index": 0}]
    assert all("process_index" in r for r in rows)


def test_graftboard_fleet_view_of_port_shards(port, tmp_path):
    """Two replica shards written by the port's stream: replica 1
    abandoned mid-stream (no close row) while replica 0 beats on; the
    fleet view merges them, finds replica 1 dead and covered by the
    reroute row."""
    tel = port.telemetry
    base = str(tmp_path / "telemetry.jsonl")
    shards = [tel.TelemetryStream(tel.shard_path(base, i), heartbeat_interval_s=0.05,
                                  process_index=i, meta={"role": "serve_replica",
                                                         "replica": i})
              for i in range(2)]
    for i, s in enumerate(shards):
        s.emit({"t": "serve", "replica": i, "queue_depth": 2 + i})
    shards[1].abandon()
    time.sleep(1.3)  # past graftboard's 1 s floor on the heartbeat gap
    shards[0].emit({"t": "reroute", "from_replica": 1, "recovered": 2, "moved": 2,
                    "shed_expired": 0})
    shards[0].emit({"t": "serve_rollup", "replica": 0, "requests": 9, "dispatches": 3,
                    "p50_ms": 4.0, "p99_ms": 9.0})
    shards[0].close()
    fl = _graftboard().build_fleet(str(tmp_path))
    assert fl["present"] == [0, 1]
    assert fl["processes"]["0"]["clean_exit"] and not fl["processes"]["1"]["clean_exit"]
    assert fl["heartbeats"]["dead"] == [1]
    sv = fl["serving"]
    assert sv["dead_replicas"] == [1] and sv["dead_without_reroute"] == []
    assert sv["per_replica"]["0"]["requests"] == 9
    assert sv["per_replica"]["1"]["queue_depth_max"] == 3


# ----------------------------------------------------------------------
# A two-replica tier on the CPU plain path
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tier_parts(port):
    samples = port.loadgen.synthetic_request_samples("qm9", 24, seed=11)
    model, cfg, _ = port.loadgen._tiny_serving_model("cpu")
    ns, es = port.padschedule.dataset_size_arrays(samples)
    st = port.engine.ServingSettings(enabled=True, batch_size=4, deadline_ms=10.0,
                                     max_open_bins=2)
    budgets = port.engine.fit_serving_budgets(ns, es, st)
    return samples, model, cfg, st, budgets


def _mk_tier(port, parts, **kw):
    samples, model, cfg, st, budgets = parts
    kw.setdefault("fleet", port.fleet.FleetSettings(
        replicas=2, heartbeat_interval_s=0.05, heartbeat_timeout_s=0.4))
    kw.setdefault("monitor", False)
    return port.fleet.ServingTier(model, cfg, None, budgets, example=samples[0],
                                  settings=st, device="cpu", **kw)


def _probe(tier, samples):
    frs = [tier.submit(s) for s in samples]
    t0 = time.monotonic()
    while not all(fr.done for fr in frs):
        assert time.monotonic() - t0 < 30.0, "probe requests stalled"
        time.sleep(0.005)
    assert not any(fr.shed for fr in frs)
    return [np.asarray(fr.result[0]).copy() for fr in frs]


def test_tier_kill_detect_reroute_no_in_deadline_drop(port, tier_parts, tmp_path):
    """run_fleet_bench's drill at CPU size: replica 1 killed mid-stream,
    detected, its requests re-routed; every class >= 1 request served;
    no executable warmed after warm-up; graftboard finds replica 1 dead
    and covered."""
    samples, model, cfg, st, _ = tier_parts
    base = str(tmp_path / "telemetry.jsonl")
    rep = port.loadgen.run_fleet_bench(
        histogram="zinc_skew", n_requests=40, deadline_ms=10.0, rate_hz=60.0,
        batch_size=4, replicas=2, policy="spec_affinity", seed=2, kill_replica=1,
        kill_after_frac=0.4, heartbeat_interval_s=0.05, heartbeat_timeout_s=0.3,
        telemetry_base=base, model_bits=(model, cfg, None), device="cpu",
    )
    assert rep["ok"], rep["gates"]
    assert rep["gates"]["detected"] and rep["gates"]["complete_in_deadline"]
    assert rep["post_warmup_compiles"] == 0
    assert not rep["tier"]["replicas"]["1"]["alive"]
    fl = _graftboard().build_fleet(str(tmp_path))
    assert 1 in fl["heartbeats"]["dead"]
    assert fl["serving"]["dead_without_reroute"] == []


def test_tier_rollover_refused_leaves_old_outputs_bitwise(port, tier_parts):
    """A NaN snapshot is refused at admission and a warm-up crash before
    the swap: both leave every replica serving the old engine, outputs
    bit for bit, and count no rollover."""
    samples, model, cfg, st, budgets = tier_parts
    tier = _mk_tier(port, tier_parts)
    try:
        probe = samples[:6]
        before = _probe(tier, probe)
        old = [h.engine for h in tier.replicas]
        bad = {k: v.clone() for k, v in model.state_dict().items()}
        name = next(k for k, v in bad.items() if v.is_floating_point())
        bad[name].view(-1)[0] = float("nan")
        with pytest.raises(port.admission.AdmissionError, match=name):
            tier.rollover(bad)
        assert tier.rollovers == 0 and [h.engine for h in tier.replicas] == old
        for a, b in zip(before, _probe(tier, probe)):
            np.testing.assert_array_equal(a, b)
        real_build = tier._build_engine
        tier._build_engine = lambda s, h: (_ for _ in ()).throw(RuntimeError("warm-up crashed"))
        with pytest.raises(RuntimeError, match="warm-up crashed"):
            tier.rollover(model.state_dict())
        tier._build_engine = real_build
        assert tier.rollovers == 0 and [h.engine for h in tier.replicas] == old
        for a, b in zip(before, _probe(tier, probe)):
            np.testing.assert_array_equal(a, b)
        # the caller's model was never written to
        assert all(bool(v.isfinite().all()) for v in model.state_dict().values()
                   if v.is_floating_point())
    finally:
        tier.close(timeout_s=30.0)


def test_tier_clean_rollover_swaps_with_nothing_lost(port, tier_parts):
    """A rollover with a concurrent stream spanning the swap: every
    request served by one generation, the old engines drained and
    closed, outputs bit for bit across the swap (same snapshot); a new
    snapshot then serves its own outputs; close() is idempotent and a
    closed tier refuses submits."""
    samples, model, cfg, st, budgets = tier_parts
    tier = _mk_tier(port, tier_parts)
    try:
        probe = samples[:6]
        before = _probe(tier, probe)
        old = [h.engine for h in tier.replicas]
        stream = []

        def drive():
            for s in samples[6:22]:
                stream.append(tier.submit(s))
                time.sleep(0.003)

        feeder = threading.Thread(target=drive, daemon=True)
        feeder.start()
        time.sleep(0.01)
        row = tier.rollover(model.state_dict(), drain_timeout_s=30.0)
        feeder.join(timeout=30)
        t0 = time.monotonic()
        while not all(r.done for r in stream):
            assert time.monotonic() - t0 < 30.0
            time.sleep(0.005)
        assert len(stream) == 16 and all(r.result is not None for r in stream)
        assert row["phase"] == "done" and row["drained"] and sorted(row["replicas"]) == [0, 1]
        assert tier.rollovers == 1 and all(o.closed for o in old)
        assert all(h.engine is not o for h, o in zip(tier.replicas, old))
        for a, b in zip(before, _probe(tier, probe)):
            np.testing.assert_array_equal(a, b)
        scaled = {k: v * 2 if v.is_floating_point() else v
                  for k, v in model.state_dict().items()}
        tier.rollover(scaled)
        after = _probe(tier, probe)
        assert any(not np.array_equal(a, b) for a, b in zip(before, after))
        assert tier.report()["router"]["shed_total"] == 0
    finally:
        tier.close(timeout_s=30.0)
        tier.close(timeout_s=30.0)
    with pytest.raises(RuntimeError, match="closed"):
        tier.submit(samples[0])
    eng = tier.replicas[1].engine
    assert eng.closed
    with pytest.raises(RuntimeError, match="closed"):
        eng.install_executables({})
