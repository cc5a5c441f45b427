"""The port's input feed (``data/pipeline.py``, ``data/prefetch.py``,
``parallel/runtime.wrap_loader``) against its serial feed and the JAX
package's, on the CPU.

- the pipeline over a ``GraphLoader`` delivers two seeded epochs bit for
  bit equal to the serial loader (every field, dtype and the block
  plan's tiles), and every field the JAX package's serial
  ``GraphLoader`` also has equals it bit for bit: workers 1/2/3, depth
  2/4, chunk 1/4, packed assembly on and off, ``PackedStore`` on and
  off, fixed, ladder and packed pads, MLIP fields, rich optional fields,
  DimeNet triplets (fixed and ladder), ``num_samples`` and
  ``drop_last``;
- ``superstep_k`` 2 against ``SuperstepLoader``, a ``skip_to`` cursor,
  and an eval loader's cache populated and replayed (K 1 and 2);
- ``collate_packed`` with mixed optional-field presence and
  ``ensure_fields``, and ``PackedStore``'s eligibility, as in the JAX
  package;
- a worker's exception raised on the consumer in order (also through
  the prefetch thread), threads that exit on an early close, workers
  outnumbering the depth, no aliasing across yields on the CPU path and
  the ``hold`` window where buffers recycle, the stats through a wrapper
  chain and into the tracer;
- ``plan_from_config``'s feed fields against ``_pipeline_from_config``
  (config, environment, patched ``os.cpu_count``);
- ``run_training`` on tests/inputs/ci.json's SchNet through the pipeline
  and through the prefetch thread equal to the serial feed bit for bit.

Every thread join is bounded by a timeout.
"""

import copy
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SHARED = ("x", "pos", "node_graph_idx", "node_slot", "node_mask", "senders", "receivers",
          "edge_mask", "graph_mask", "edge_attr", "edge_shifts", "y_graph", "y_node",
          "graph_attr", "dataset_id", "pe", "rel_pe", "cell", "energy", "forces", "t_kj",
          "t_ji", "triplet_mask")
FIELDS = ("x", "pos", "edge_index", "edge_attr", "y_graph", "y_node", "graph_attr",
          "dataset_id", "pe", "rel_pe", "cell", "energy", "forces")


@pytest.fixture(scope="module")
def port():
    import types

    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph, loader, pipeline, prefetch, synthetic
    from hydragnn_tpu_torch.parallel import runtime
    from hydragnn_tpu_torch.utils import tracer

    return types.SimpleNamespace(torch=torch, runner=runner, graph=graph, loader=loader,
                                 pipeline=pipeline, prefetch=prefetch, synthetic=synthetic,
                                 runtime=runtime, tracer=tracer)


@pytest.fixture(scope="module")
def jax_side():
    import types

    import tests._cpu  # noqa: F401
    from hydragnn_tpu.data import graph, loader, pipeline
    from hydragnn_tpu.parallel import runtime

    return types.SimpleNamespace(graph=graph, loader=loader, pipeline=pipeline,
                                 runtime=runtime)


def _molecule(cls, rng, n, i, rich=False, forces=False):
    pos = rng.uniform(0, 3.0, (n, 3)).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    snd, rcv = np.nonzero((d < 2.5) & ~np.eye(n, dtype=bool))
    kw = dict(x=rng.normal(size=(n, 2)).astype(np.float32), pos=pos,
              edge_index=np.stack([snd, rcv]).astype(np.int64),
              y_graph=np.array([float(i), 2.0 * i], np.float32))
    if rich:
        e = len(snd)
        kw.update(edge_attr=rng.normal(size=(e, 4)).astype(np.float32),
                  pe=rng.normal(size=(n, 8)).astype(np.float32),
                  rel_pe=rng.normal(size=(e, 8)).astype(np.float32),
                  cell=np.eye(3, dtype=np.float32) * float(n),
                  y_node=rng.normal(size=(n, 3)).astype(np.float32),
                  graph_attr=rng.normal(size=(5,)).astype(np.float32), dataset_id=i % 3)
    if forces:
        kw.update(energy=float(rng.normal()), forces=rng.normal(size=(n, 3)).astype(np.float32))
    return cls(**kw)


def _samples(cls, k, seed=7, **kw):
    rng = np.random.default_rng(seed)
    return [_molecule(cls, rng, int(rng.integers(4, 9)), i, **kw) for i in range(k)]


def _jax_samples(jax_side, samples):
    return [jax_side.graph.GraphSample(**{f: getattr(s, f) for f in FIELDS
                                          if getattr(s, f) is not None})
            for s in samples]


def _assert_same(a, b):
    """Two port deliveries bit for bit (fields, dtypes, plan tiles)."""
    from hydragnn_tpu_torch.data.loader import MacroBatch

    if isinstance(a, MacroBatch):
        assert isinstance(b, MacroBatch) and a.k == b.k
        for x, y in zip(a.batches, b.batches):
            _assert_same(x, y)
        return
    fa, fb = a.arrays(), b.arrays()
    assert fa.keys() == fb.keys(), fa.keys() ^ fb.keys()
    for k, v in fa.items():
        assert v.dtype == fb[k].dtype and v.shape == fb[k].shape, k
        assert np.array_equal(v.numpy(), fb[k].numpy()), k
    assert a.seg_tile == b.seg_tile


def _assert_shared_with_jax(port_batch, jax_batch):
    """Every field both packages' batches carry, bit for bit (the block
    plans differ by design: the port's is at the Hopper tiles)."""
    n = 0
    for f in SHARED:
        mine, theirs = getattr(port_batch, f), getattr(jax_batch, f, None)
        assert (mine is None) == (theirs is None), f
        if mine is not None:
            theirs = np.asarray(theirs)
            assert mine.numpy().dtype == theirs.dtype, f
            assert np.array_equal(mine.numpy(), theirs), f
            n += 1
    assert n >= 9


CASES = {
    "fixed": ({}, {}, dict(workers=3, depth=2, chunk=1)),
    "ladder-nostore": ({"fixed_pad": False}, {}, dict(workers=1, depth=4, chunk=4, store=False)),
    "packed-bins-recycled": ({"packing": True}, {}, dict(workers=3, depth=4, chunk=4,
                                                          recycle=True)),
    "collate-entry": ({}, {}, dict(workers=2, depth=2, chunk=4, packed=False)),
    "mlip": ({}, {"forces": True}, dict(workers=3, depth=4, chunk=1)),
    "rich-nostore": ({"with_segment_plan": False}, {"rich": True},
                     dict(workers=3, depth=2, chunk=4, store=False)),
    "rich-store": ({}, {"rich": True}, dict(workers=2, depth=2, chunk=2, recycle=True)),
    "triplets": ({"with_triplets": True}, {}, dict(workers=2, depth=4, chunk=1)),
    "triplets-ladder": ({"with_triplets": True, "fixed_pad": False}, {},
                        dict(workers=3, depth=2, chunk=4)),
    "num-samples": ({"num_samples": 31}, {}, dict(workers=2, depth=4, chunk=4)),
    "drop-last-ladder": ({"drop_last": True, "fixed_pad": False}, {},
                         dict(workers=3, depth=2, chunk=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_equals_serial_and_jax(port, jax_side, case):
    lkw, dkw, pkw = CASES[case]
    pkw = dict(pkw)
    store = pkw.pop("store", True)
    samples = _samples(port.graph.GraphSample, 23, **dkw)
    kw = dict(shuffle=True, seed=1, **lkw)
    serial = port.loader.GraphLoader(samples, 5, **kw)
    pipe = port.pipeline.ParallelPipelineLoader(port.loader.GraphLoader(samples, 5, **kw),
                                                **pkw)
    if not store:
        pipe._store_tried = True  # keep the per-sample collate_packed path
    jax_kw = dict(kw, with_segment_plan=lkw.get("with_segment_plan", True))
    ref = jax_side.loader.GraphLoader(_jax_samples(jax_side, samples), 5, **jax_kw)
    for epoch in (0, 1):
        for ld in (serial, pipe, ref):
            ld.set_epoch(epoch)
        n = 0
        for a, b, c in zip(serial, pipe, ref):  # a recycling pipe: compared as it delivers
            _assert_same(a, b)
            _assert_shared_with_jax(b, c)
            n += 1
        assert n == len(serial) == len(pipe) == len(ref) > 2
    assert (pipe._store is not None) == (store and pkw.get("packed", True))


@pytest.mark.parametrize("k", [1, 2])
def test_supersteps_cursor_and_cache_replay(port, k):
    """K 2 against ``SuperstepLoader`` (K 1 against the plain loader) on
    packed bins: a full epoch, then one resumed at step 3 (a cursor
    inside a group delivers the group's rest as single steps, as the
    serial feed does); an eval loader with ``cache_batches``: the first
    epoch collated, the later ones replayed from the cache."""
    samples = _samples(port.graph.GraphSample, 60)
    GL = port.loader.GraphLoader

    def serial(ld):
        return port.loader.SuperstepLoader(ld, k) if k > 1 else ld

    kw = dict(shuffle=True, seed=1, packing=True, pack_max_budgets=1)
    a = serial(GL(samples, 5, **kw))
    b = port.pipeline.ParallelPipelineLoader(GL(samples, 5, **kw), workers=3, superstep_k=k,
                                             recycle=True)
    for epoch, cursor in ((0, 0), (1, 3)):
        for ld in (a, b):
            ld.set_epoch(epoch)
            if cursor:
                ld.skip_to(cursor)
        xs, ys = list(a), iter(b)  # b recycles: compared as it delivers
        for x, y in zip(xs, ys):
            _assert_same(x, y)
        assert next(ys, None) is None and len(xs) > 0
        macros = sum(isinstance(x, port.loader.MacroBatch) for x in xs)
        assert (macros > 0) == (k > 1)
    assert port.loader.feed_supports_skip(port.prefetch.PrefetchLoader(b))
    eval_base = GL(samples[:23], 5, cache_batches=True, packing=True, pack_max_budgets=1)
    c = serial(GL(samples[:23], 5, cache_batches=True, packing=True, pack_max_budgets=1))
    d = port.pipeline.ParallelPipelineLoader(eval_base, workers=2, superstep_k=k, recycle=True)
    first = [copy.deepcopy(x) for x in d]
    cached = d._cache if k > 1 else eval_base._batch_cache
    assert cached is not None and len(cached) == len(first)
    for epoch in (1, 2):
        d.set_epoch(epoch)
        c.set_epoch(epoch)
        again = list(d)
        assert len(again) == len(first) == len(list(c))
        for x, y, z in zip(first, again, c):
            _assert_same(x, y)
            _assert_same(y, z)
    assert d.stats.epochs == 3


def test_collate_packed_mixed_presence_and_store_eligibility(port, jax_side):
    """Within-batch mixed presence with ``ensure_fields``: the port's
    ``collate_packed`` equals its ``collate`` bit for bit, and the JAX
    package's ``collate``/``collate_packed`` on every shared field; the
    store's eligibility (a list with all-or-none optional fields and
    consistent widths, ``HYDRAGNN_TPU_PIPELINE_STORE=0`` off) equals the
    JAX package's ``PackedStore.build`` on each case."""
    rng = np.random.default_rng(0)
    samples = []
    for i in range(6):
        n = int(rng.integers(4, 8))
        pos = rng.uniform(0, 3.0, (n, 3)).astype(np.float32)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        snd, rcv = np.nonzero((d < 2.5) & ~np.eye(n, dtype=bool))
        kw = dict(x=rng.normal(size=(n, 1)).astype(np.float32),
                  edge_index=np.stack([snd, rcv]).astype(np.int64),
                  y_graph=np.array([float(i)], np.float32))
        if i % 2 == 0:
            kw["pos"] = pos
            kw["pe"] = rng.normal(size=(n, 4)).astype(np.float32)
            kw["cell"] = np.eye(3, dtype=np.float32) * 2.0
        samples.append(port.graph.GraphSample(**kw))
    spec = port.graph.PadSpec.for_samples(samples, with_triplets=True)
    ensure = {"pe": 4, "graph_attr": 3, "edge_attr": 2}
    for plan in (False, True):
        want = port.graph.collate(samples, spec, with_segment_plan=plan, ensure_fields=ensure)
        got = port.pipeline.collate_packed(samples, spec, with_segment_plan=plan,
                                           ensure_fields=ensure).to("cpu")
        _assert_same(want, got)
    jsamples = _jax_samples(jax_side, samples)
    for ref in (jax_side.graph.collate(jsamples, jax_side.graph.PadSpec(**vars(spec)),
                                       ensure_fields=ensure),
                jax_side.pipeline.collate_packed(
                    jsamples, jax_side.graph.PadSpec(**vars(spec)), ensure_fields=ensure)):
        _assert_shared_with_jax(port.graph.collate(samples, spec, ensure_fields=ensure), ref)

    uniform = _samples(port.graph.GraphSample, 8, rich=True)
    wide = [dataclasses.replace(s, x=np.zeros((s.num_nodes, 3), np.float32))
            for s in uniform[:2]] + uniform[2:]
    cases = {"uniform": uniform, "mixed": samples, "tuple": tuple(uniform), "empty": [],
             "widths": wide}
    for name, ds in cases.items():
        mine = port.pipeline.PackedStore.build(ds) is not None
        theirs = jax_side.pipeline.PackedStore.build(
            _jax_samples(jax_side, ds) if isinstance(ds, list) else
            tuple(_jax_samples(jax_side, ds))) is not None
        assert mine == theirs == (name == "uniform"), name
    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRAGNN_TPU_PIPELINE_STORE", "0")
    try:
        assert port.pipeline.PackedStore.build(uniform) is None
    finally:
        mp.undo()
    store = port.pipeline.PackedStore.build(uniform)
    idx = np.array([5, 0, 3])
    spec = port.graph.PadSpec.for_samples([uniform[i] for i in idx])
    _assert_same(port.graph.collate([uniform[i] for i in idx], spec, with_segment_plan=True),
                 store.assemble(idx, spec, with_segment_plan=True).to("cpu"))


def _pipeline_threads():
    return {t for t in threading.enumerate() if t.name.startswith(("hgtpu-pipeline",
                                                                   "hgtpu-prefetch"))}


def _wait_gone(threads, seconds=5.0):
    deadline = time.time() + seconds
    while time.time() < deadline:
        alive = [t for t in threads if t.is_alive()]
        if not alive:
            return []
        time.sleep(0.02)
    return [t.name for t in threads if t.is_alive()]


def test_worker_error_and_early_close(port):
    """A worker's exception (a partially labeled batch) is raised on the
    consumer after the batches before it, in order, directly and through
    the prefetch thread; closing either feed early stops its threads.
    The loader refuses such a dataset at construction through its
    dataset-wide field map, so these loaders are given an explicit map,
    which skips that check, for the batch to reach a worker."""
    samples = _samples(port.graph.GraphSample, 20, forces=True)
    samples[13] = dataclasses.replace(samples[13], energy=None)
    with pytest.raises(ValueError, match="Partially-labeled dataset: energy present on 19/20"):
        port.loader.GraphLoader(samples, 4)

    def GL(dataset, batch_size):
        return port.loader.GraphLoader(dataset, batch_size, ensure_fields={})

    serial = GL(samples, 4)
    good = []
    with pytest.raises(ValueError, match="Partially-labeled"):
        for b in serial:
            good.append(b)
    assert len(good) == 3
    for wrap in (lambda ld: ld, port.prefetch.PrefetchLoader):
        feed = wrap(port.pipeline.ParallelPipelineLoader(GL(samples, 4), workers=3, depth=2,
                                                         chunk=1))
        got = []
        with pytest.raises(ValueError, match="Partially-labeled"):
            for b in feed:
                got.append(b)
        assert len(got) == len(good)
        for a, b in zip(good, got):
            _assert_same(a, b)
    before = _pipeline_threads()
    for wrap in (lambda ld: ld, port.prefetch.PrefetchLoader):
        it = iter(wrap(port.pipeline.ParallelPipelineLoader(
            GL(_samples(port.graph.GraphSample, 64), 4), workers=3, depth=2)))
        next(it)
        next(it)
        mine = _pipeline_threads() - before
        assert mine
        it.close()
        assert not _wait_gone(mine), "feed threads outlived an early close"


def test_workers_beyond_depth_never_deadlock(port):
    pipe = port.pipeline.ParallelPipelineLoader(
        port.loader.GraphLoader(_samples(port.graph.GraphSample, 60, seed=13), 2, shuffle=True),
        workers=4, depth=1, chunk=1, recycle=True)
    done = []

    def run():
        for epoch in range(3):
            pipe.set_epoch(epoch)
            done.append(sum(1 for _ in pipe))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive(), "pipeline deadlocked with workers > depth"
    assert done == [30, 30, 30]


def test_buffers_alias_nothing_on_the_cpu_path(port):
    """``wrap_loader`` on the CPU gives every batch its own buffers: a
    mutated delivery leaves the others, and a whole epoch kept in a list
    equals the serial feed. Where buffers recycle (the card's feed), a
    delivery stays intact for ``hold`` further deliveries."""
    samples = _samples(port.graph.GraphSample, 40)
    GL = port.loader.GraphLoader
    plan = port.runtime.ParallelPlan(scheme="single", pipeline_workers=2, pipeline_depth=2,
                                     pipeline_chunk=1, superstep_steps=1)
    feed = port.runtime.wrap_loader(plan, GL(samples, 4, shuffle=True, packing=True),
                                    device="cpu")
    assert isinstance(feed, port.pipeline.ParallelPipelineLoader) and not feed.recycle
    it = iter(feed)
    b0 = next(it)
    b0.x[:] = -999.0
    rest = list(it)
    assert not any(bool((b.x == -999.0).any()) for b in rest)
    serial = list(GL(samples, 4, shuffle=True, packing=True))
    for a, b in zip(serial[1:], rest):
        _assert_same(a, b)
    hold = 3
    pipe = port.pipeline.ParallelPipelineLoader(GL(samples, 4, fixed_pad=True), workers=2,
                                                depth=2, chunk=1, recycle=True, hold=hold)
    got = list(zip(GL(samples, 4, fixed_pad=True), pipe))
    assert len(got) == 10
    it = iter(pipe)
    kept = [next(it) for _ in range(hold + 1)]
    for (a, _), b in zip(got, kept):
        _assert_same(a, b)  # the first delivery survived `hold` more
    it.close()
    assert pipe._pool  # released buffers went back to the pool


def test_stats_through_the_chain_and_into_the_tracer(port):
    tr = port.tracer
    tr._TRACERS.clear()
    tr.initialize(["RegionTimer"])
    try:
        from hydragnn_tpu_torch.train.loop import _run_epoch

        pipe = port.pipeline.ParallelPipelineLoader(
            port.loader.GraphLoader(_samples(port.graph.GraphSample, 20), 4), workers=2,
            depth=2)
        timer = tr._TRACERS["RegionTimer"]
        list(port.prefetch.PrefetchLoader(pipe))
        assert "pipeline/collate_s" not in timer.counts  # the feed leaves the flush
        st = port.pipeline.pipeline_stats(port.prefetch.PrefetchLoader(pipe))
        assert st is pipe.stats
        seen = []
        state = dataclasses.make_dataclass("S", ["step_t", "graphs"])(port.torch.zeros(()),
                                                                     None)
        _run_epoch(lambda st_, acc, batches: seen.extend(batches), state,
                   port.prefetch.PrefetchLoader(pipe), train=False)
        d = st.as_dict()
        assert d["epochs"] == 2 and d["delivered_batches"] >= 1 and "collate_ms_avg" in d
        assert len(seen) == 5
        assert timer.counts.get("pipeline/collate_s", 0) == 1  # once, by the loop's pass
        assert "pipeline/starved_steps" in timer.totals
        assert "eval/pipeline_starved_steps" in timer.totals
        assert port.pipeline.pipeline_stats(port.loader.GraphLoader(_samples(
            port.graph.GraphSample, 4), 2)) is None
    finally:
        tr._TRACERS.clear()


@pytest.mark.parametrize("cpus,pcfg,env", [
    (8, {}, {}),
    (2, {}, {}),
    (5, {"prefetch": 0}, {}),
    (8, {"pipeline": {"workers": 3, "depth": 2, "chunk": 1, "packed": False},
         "prefetch": 3}, {}),
    (8, {"pipeline": {"workers": 3}}, {"HYDRAGNN_TPU_PIPELINE_WORKERS": "1",
                                        "HYDRAGNN_TPU_PIPELINE_DEPTH": "6",
                                        "HYDRAGNN_TPU_PIPELINE_CHUNK": "2",
                                        "HYDRAGNN_TPU_PIPELINE_PACKED": "false"}),
    (16, {"pipeline": {"workers": 0}}, {"HYDRAGNN_TPU_PIPELINE_PACKED": "1"}),
])
def test_feed_fields_resolve_as_in_jax(port, jax_side, monkeypatch, cpus, pcfg, env):
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    fields = ("prefetch", "pipeline_workers", "pipeline_depth", "pipeline_packed",
              "pipeline_chunk")
    config = {"NeuralNetwork": {"Training": {"Parallelism": dict(pcfg)}}}
    for scheme, n in (("single", 1), ("dp", 2)):
        config["NeuralNetwork"]["Training"]["Parallelism"]["scheme"] = scheme
        plan = port.runtime.plan_from_config(config, n_devices=n)
        want = {"prefetch": int(pcfg.get("prefetch", 2)),
                **jax_side.runtime._pipeline_from_config(pcfg)}
        assert {f: getattr(plan, f) for f in fields} == want


def _ci_base(port, tmp_path):
    path = str(tmp_path / "dataset" / "unit_test")
    port.synthetic.deterministic_graph_data(path, number_configurations=120, seed=7)
    with open(os.path.join(HERE, "inputs", "ci.json")) as f:
        base = json.load(f)
    base["Dataset"]["path"] = {"total": path}
    base["NeuralNetwork"]["Training"].update(num_epoch=2, batch_size=8)
    return base


def test_run_training_through_the_feed_equals_serial(port, tmp_path, monkeypatch):
    """ci.json's SchNet (2 epochs, batch 8): through two collation
    workers, through the prefetch thread alone, and serially; every
    history entry, parameter, optimizer entry and the prediction bit for
    bit, and each run's train feed the one asked for."""
    monkeypatch.chdir(tmp_path)
    base = _ci_base(port, tmp_path)
    wrapped = []
    wrap = port.runtime.wrap_loader

    def spy(*a, **kw):
        wrapped.append(wrap(*a, **kw))
        return wrapped[-1]

    monkeypatch.setattr(port.runtime, "wrap_loader", spy)
    feeds = {"pipeline": ({"workers": 2, "depth": 2, "chunk": 1}, 2),
             "prefetch": ({"workers": 0}, 2), "serial": ({"workers": 0}, 0)}
    runs = {}
    for name, (pl, prefetch) in feeds.items():
        config = copy.deepcopy(base)
        config["NeuralNetwork"]["Training"]["Parallelism"] = {"pipeline": pl,
                                                              "prefetch": prefetch}
        config["Dataset"]["name"] = f"feed_{name}"
        wrapped.clear()
        state, model, cfg, hist, full = port.runner.run_training(config, device="cpu")
        runs[name] = (state, hist, port.runner.run_prediction(
            full, state=state, model=model, cfg=cfg))
        kind = type(wrapped[0]).__name__
        assert kind == {"pipeline": "ParallelPipelineLoader", "prefetch": "PrefetchLoader",
                        "serial": "GraphLoader"}[name], kind
    s0, h0, p0 = runs["serial"]
    for name in ("pipeline", "prefetch"):
        s1, h1, p1 = runs[name]
        assert s1.step == s0.step > 0
        for f in dataclasses.fields(h0):
            if f.name != "epoch_seconds":
                assert np.array_equal(np.asarray(getattr(h0, f.name)),
                                      np.asarray(getattr(h1, f.name))), (name, f.name)
        for (k, a), (_, b) in zip(s0.model.state_dict().items(),
                                  s1.model.state_dict().items()):
            assert port.torch.equal(a, b), (name, k)
        o0, o1 = s0.optimizer.state_dict(), s1.optimizer.state_dict()
        for i, st in o0["state"].items():
            for k, v in st.items():
                assert port.torch.equal(o1["state"][i][k], v), (name, i, k)
        assert p0[0] == p1[0]
        for a, b in zip(p0[3], p1[3]):
            assert np.array_equal(a, b)
