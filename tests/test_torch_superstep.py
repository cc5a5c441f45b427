"""The port's supersteps against the JAX package's, on the CPU.

- ``superstep_groups`` (K = 2, 3, 5), ``auto_superstep_k`` and
  ``resolve_superstep_k`` equal the JAX package's bit for bit on the
  packed plans of polymers.json (the example's 300 chains, batch 32) and
  zinc.json (zinc.py's 400 molecules, batch 64): group boundaries, batch
  indices and specs; ``auto`` on twenty epochs' plans (past its 64-step
  floor) and under the host-byte cap; ``HYDRAGNN_TPU_MAX_NUM_BATCH``
  forcing K = 1; the steps grammar;
- the port's ``SuperstepLoader`` delivers the plan's batches in order,
  full groups as ``MacroBatch`` and run tails as single batches;
- ``run_training`` on tests/inputs/ci.json's SchNet with
  ``superstep.steps: 2`` equals ``steps: 1`` bit for bit: every history
  entry, every parameter, the optimizer state, and the prediction.

With tests/test_torch_train.py (the port's run_training against the JAX
package's) and the JAX package's tests/test_superstep.py (its K-step
scan against K single steps), this holds the port's supersteps against
the JAX package's without a second JAX compile.
"""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from tests import _torch_polymers

HERE = os.path.dirname(os.path.abspath(__file__))
ZINC = os.path.join(HERE, "..", "examples", "zinc")
FIELDS = ("x", "pos", "edge_index", "pe", "rel_pe", "y_graph", "y_node")


@pytest.fixture(scope="module")
def port():
    import types

    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph, loader, padschedule, synthetic
    from hydragnn_tpu_torch.parallel import runtime
    from hydragnn_tpu_torch.train import loop

    return types.SimpleNamespace(torch=torch, runner=runner, graph=graph, loader=loader,
                                 pads=padschedule, synthetic=synthetic, runtime=runtime,
                                 loop=loop)


@pytest.fixture(scope="module")
def jax_side():
    import types

    import tests._cpu  # noqa: F401
    from hydragnn_tpu.data import graph, loader, padschedule
    from hydragnn_tpu.parallel import runtime

    return types.SimpleNamespace(graph=graph, loader=loader, pads=padschedule,
                                 runtime=runtime)


def _convert(samples, cls):
    return [cls(**{f: getattr(s, f) for f in FIELDS if getattr(s, f, None) is not None})
            for s in samples]


@pytest.fixture(scope="module")
def plans(port, jax_side):
    """{name: (port train loader, JAX train loader, batch size)} for
    polymers.json's and zinc.json's packed train splits."""
    out = {}
    poly = _torch_polymers.polymer_splits()[0]
    sys.path.insert(0, ZINC)
    try:
        from zinc import synthetic_zinc
    finally:
        sys.path.remove(ZINC)
    zinc = jax_side.loader.split_dataset(synthetic_zinc(400), 0.8)[0]
    for name, p_set, j_set, batch in (
        ("polymers", poly, _convert(poly, jax_side.graph.GraphSample), 32),
        ("zinc", _convert(zinc, port.graph.GraphSample), zinc, 64),
    ):
        pk = port.runner.packing_settings({"NeuralNetwork": {"Training": {}}})
        on, budgets, slack = port.runner.resolve_packing(pk, batch, p_set, seed=0)
        assert on, name
        ns, es = jax_side.pads.dataset_size_arrays(j_set)
        want = jax_side.pads.packing_beats_ladder(ns, es, batch, max_budgets=2, seed=0)
        tl = port.loader.GraphLoader(p_set, batch, shuffle=True, seed=0, packing=True,
                                     pack_budgets=budgets)
        jl = jax_side.loader.GraphLoader(j_set, batch, shuffle=True, seed=0, packing=True,
                                         pack_budgets=want[0])
        out[name] = (tl, jl, batch)
    return out


def _key(spec):
    return (spec.num_nodes, spec.num_edges, spec.num_graphs)


def _same_groups(got, want):
    assert [len(g) for g in got] == [len(g) for g in want]
    for gg, gw in zip(got, want):
        for (gi, gs), (wi, ws) in zip(gg, gw):
            np.testing.assert_array_equal(gi, wi)
            assert _key(gs) == _key(ws)


@pytest.mark.parametrize("name", ["polymers", "zinc"])
def test_grouping_matches_jax(port, jax_side, plans, name):
    tl, jl, _ = plans[name]
    for ep in (0, 1):
        got, want = list(tl.epoch_plan(ep)), list(jl.epoch_plan(ep))
        for k in (1, 2, 3, 5):
            g = port.pads.superstep_groups(got, k)
            _same_groups(g, jax_side.pads.superstep_groups(want, k))
            assert [e for grp in g for e in grp] == got  # order and content kept
            if k > 1:
                assert any(len(grp) == k for grp in g), (name, ep, k)
    long_got = [e for ep in range(20) for e in tl.epoch_plan(ep)]
    long_want = [e for ep in range(20) for e in jl.epoch_plan(ep)]
    assert len(long_got) >= 64
    for cap in (256 << 20, 1 << 20, 4 << 20):
        assert (port.pads.auto_superstep_k(long_got, max_host_bytes=cap)
                == jax_side.pads.auto_superstep_k(long_want, max_host_bytes=cap))
    assert port.pads.auto_superstep_k(got) == jax_side.pads.auto_superstep_k(want) == 1
    for spec in {_key(s): s for _, s in got}.values():
        j_spec = jax_side.graph.PadSpec(*_key(spec))
        assert port.pads.estimate_spec_bytes(spec) == jax_side.pads.estimate_spec_bytes(j_spec)


@pytest.mark.parametrize("name", ["polymers", "zinc"])
def test_resolve_superstep_k_matches_jax(port, jax_side, plans, name, monkeypatch):
    tl, jl, _ = plans[name]
    for steps in (1, 2, "3", "auto"):
        pcfg = {"superstep": {"steps": steps}}
        got = port.runtime._superstep_from_config(pcfg)
        want = jax_side.runtime._superstep_from_config(pcfg)
        assert got == want
        plan = jax_side.runtime.ParallelPlan(scheme="single", **want)
        assert (port.runtime.resolve_superstep_k(got, tl)
                == jax_side.runtime.resolve_superstep_k(plan, jl))
    monkeypatch.setenv("HYDRAGNN_TPU_MAX_NUM_BATCH", "4")
    settings = port.runtime._superstep_from_config({"superstep": {"steps": 4}})
    assert port.runtime.resolve_superstep_k(settings, tl) == 1
    for bad in ("two", True):
        with pytest.raises(ValueError):
            port.runtime._superstep_from_config({"superstep": {"steps": bad}})


def test_superstep_loader_delivers_the_plan(port, plans):
    tl, _, _ = plans["polymers"]
    tl.set_epoch(1)
    plan = list(tl.epoch_plan(1))
    ss = port.loader.SuperstepLoader(tl, 2)
    items = list(ss)
    assert len(items) == len(ss) == len(port.pads.superstep_groups(plan, 2))
    flat = [b for it in items
            for b in (it.batches if isinstance(it, port.loader.MacroBatch) else [it])]
    assert any(isinstance(it, port.loader.MacroBatch) and it.k == 2 for it in items)
    assert len(flat) == len(plan)
    for b, (idx, spec) in zip(flat, plan):
        assert (b.num_nodes, b.num_edges, b.num_graphs) == _key(spec)
        assert int(b.graph_mask.sum()) == len(idx)
    with pytest.raises(ValueError):
        port.loader.SuperstepLoader(tl, 1)


def test_run_training_k2_equals_k1(port, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "dataset" / "unit_test")
    port.synthetic.deterministic_graph_data(path, number_configurations=120, seed=7)
    with open(os.path.join(HERE, "inputs", "ci.json")) as f:
        base = json.load(f)
    base["Dataset"]["path"] = {"total": path}
    training = base["NeuralNetwork"]["Training"]
    training.update(num_epoch=2, batch_size=8)
    ks = []
    fold = port.loop.fold_step_metrics

    def spy(acc, tots, tasks, gs):
        ks.append(int(gs.shape[0]))
        return fold(acc, tots, tasks, gs)

    monkeypatch.setattr(port.loop, "fold_step_metrics", spy)
    runs = {}
    for k in (1, 2):
        config = copy.deepcopy(base)
        config["NeuralNetwork"]["Training"]["Parallelism"] = {"superstep": {"steps": k}}
        ks.clear()
        state, model, cfg, hist, full = port.runner.run_training(config, device="cpu")
        runs[k] = (state, hist, port.runner.run_prediction(
            full, state=state, model=model, cfg=cfg), list(ks))
        assert len(hist.train_tasks[0]) == port.loop.superstep_task_count(cfg) == 1
    assert max(runs[1][3]) == 1 and max(runs[2][3]) == 2
    (s1, h1, p1, _), (s2, h2, p2, _) = runs[1], runs[2]
    assert s1.step == s2.step > 0
    for f in dataclasses.fields(h1):
        if f.name == "epoch_seconds":
            continue
        assert np.array_equal(np.asarray(getattr(h1, f.name)),
                              np.asarray(getattr(h2, f.name))), f.name
    for (n, a), (_, b) in zip(s1.model.state_dict().items(), s2.model.state_dict().items()):
        assert port.torch.equal(a, b), n
    o1, o2 = s1.optimizer.state_dict(), s2.optimizer.state_dict()
    for i, st in o1["state"].items():
        for k, v in st.items():
            assert port.torch.equal(o2["state"][i][k], v), (i, k)
    assert p1[0] == p2[0]
    for a, b in zip(p1[3], p2[3]):
        assert np.array_equal(a, b)
