"""The serving remainder of the port: export to a file, the MLIP serving
form, executables installed from artifacts, and the export CLI.

- ``export_inference``/``load_exported`` round trip on the CPU: the
  loaded program equals the live model bit for bit, from bytes and from
  a file, at the export batch and at a second batch of the same budget,
  and a packed batch's padding slots are inert;
- ``make_forward(with_forces=True)`` and the exported MLIP artifact
  (md17.json's stack: PaiNN with a graph energy head, sum pooling, at
  small width) against the JAX package's ``make_forward(...,
  with_forces=True)`` on the same inputs and weights (``params_from_jax``;
  the inputs drawn with numpy from a seed), with the block plan: energies
  at f32 rtol 1e-5 / atol 1e-4, forces at the gradient tolerance rtol
  1e-4 / atol 1e-3 (tests/test_pallas_segment.py:341, :808), each atol
  scaled by the reference's largest magnitude where that is below 1;
- a ``with_forces`` engine: served energies and forces equal a direct
  ``energy_and_forces(create_graph=False)`` at the same bin bit for bit,
  and an engine serving the exported MLIP artifacts per budget
  (``from_exported`` -> ``install_executables``) equals it bit for bit;
- ``install_executables`` refuses a map that misses a budget and leaves
  the engine as it was, releases what a warm-up that fails midway had
  built, and a second install replaces the first;
- ``collate(ensure_fields=...)`` equals the JAX package's bit for bit on
  a mixed batch (zero-filled fields, an identity ``cell``), and an engine
  with ``ensure_fields`` serves molecules beside a periodic example;
- ``python -m hydragnn_tpu_torch.export`` from a small ``run_training``
  checkpoint;
- the entry points (``export_inference``, ``load_exported``,
  ``ServingTier``) need a card or an explicit ``"cpu"``, and an artifact
  without a program for the asked device raises.
"""

import io
import json
import os
import types
import zipfile

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax

from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.export import make_forward as jax_make_forward
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.serve import loadgen as jloadgen

from tests.test_interatomic_potential import mock_molecular_samples

F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_close(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0), err_msg=name
    )


@pytest.fixture(scope="module")
def port():
    """torch and the port's modules, imported when this file runs rather
    than at collection."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import export
    from hydragnn_tpu_torch.data import graph, padschedule
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.serve import batcher, engine, fleet, loadgen
    from hydragnn_tpu_torch.train import mlip

    return types.SimpleNamespace(
        torch=torch, export=export, graph=graph, padschedule=padschedule,
        convert=convert, create=create, spec=spec, batcher=batcher, engine=engine,
        fleet=fleet, loadgen=loadgen, mlip=mlip,
    )


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool((g == w).all()), "outputs differ"


# ----------------------------------------------------------------------
# Export round trip (SchNet)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def schnet(port, tmp_path_factory):
    samples = port.loadgen.synthetic_request_samples("qm9", 12, seed=4)
    model, cfg, _ = port.loadgen._tiny_serving_model("cpu")
    spec = port.graph.PackSpec(num_nodes=128, num_edges=256, num_graphs=7)
    first = port.graph.collate(samples[:5], spec.pad_spec(), with_segment_plan=True)
    second = port.graph.collate(samples[5:9], spec.pad_spec(), with_segment_plan=True)
    path = str(tmp_path_factory.mktemp("art") / "sub" / "schnet.pt2z")
    blob = port.export.export_inference(model, cfg, None, first, path=path,
                                        devices=["cpu"])
    with open(path, "rb") as fh:
        assert fh.read() == blob
    return samples, model, cfg, spec, first, second, blob, path


@pytest.mark.parametrize("source", ["bytes", "file"])
def test_export_round_trip_bit_for_bit(port, schnet, source):
    """The loaded program equals the live model at the export batch and
    at another batch of the budget; padding slots are inert."""
    samples, model, cfg, spec, first, second, blob, path = schnet
    fn = port.export.load_exported(path if source == "file" else blob, device="cpu")
    assert fn.info["devices"] == ["cpu"] and not fn.info["with_forces"]
    live = port.export.make_forward(model, cfg)
    for batch in (first, second):
        _equal(fn(batch), live(batch))
    # Padding node rows hold junk: the real graphs' outputs do not move.
    rng = np.random.default_rng(0)
    n_real = int(second.node_mask.sum())
    junk = type(second)(**{**second.__dict__})
    junk.x = second.x.clone()
    junk.pos = second.pos.clone()
    junk.x[n_real:] = port.torch.from_numpy(
        rng.normal(size=tuple(junk.x[n_real:].shape)).astype(np.float32))
    junk.pos[n_real:] = port.torch.from_numpy(
        rng.uniform(0, 4, size=tuple(junk.pos[n_real:].shape)).astype(np.float32))
    real = second.graph_mask
    _equal([fn(junk)[0][real]], [fn(second)[0][real]])
    with pytest.raises(ValueError, match="exported at"):
        fn(port.graph.collate(samples[:2], port.graph.PadSpec(64, 128, 3),
                              with_segment_plan=True))


def test_entry_points_need_a_device_or_cpu(port, schnet):
    """Without a card, ``export_inference`` for the card, ``load_exported``
    and ``ServingTier`` raise unless the caller names the CPU; an
    artifact without a program for the asked device raises, naming the
    devices it holds."""
    samples, model, cfg, spec, first, _, blob, _ = schnet
    torch = port.torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.export.export_inference(model, cfg, None, first, devices=["cuda"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.export.load_exported(blob)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.fleet.ServingTier(model, cfg, None, [spec], example=samples[0],
                                   monitor=False)
    # An artifact holding only a card's program refuses the CPU.
    src = zipfile.ZipFile(io.BytesIO(blob))
    meta = json.loads(src.read("artifact.json"))
    meta["devices"] = ["cuda:0"]
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as zf:
        zf.writestr("artifact.json", json.dumps(meta))
        zf.writestr("program_cuda_0.pt2", src.read("program_cpu.pt2"))
    with pytest.raises(ValueError, match=r"no program for cpu.*\['cuda:0'\]"):
        port.export.load_exported(out.getvalue(), device="cpu")


def test_install_executables_refuses_a_map_missing_a_budget(port, schnet):
    samples, model, cfg, spec, first, _, blob, _ = schnet
    small = port.graph.PackSpec(num_nodes=64, num_edges=128, num_graphs=4)
    eng = port.engine.ServingEngine(model, cfg, None, [spec, small], example=samples[0],
                                    device="cpu")
    before = dict(eng._exec)
    fn = port.export.load_exported(blob, device="cpu")
    with pytest.raises(ValueError, match=r"does not cover budget shape\(s\) \[\(64, 128, 4\)\]"):
        port.engine.ServingEngine(model, cfg, None, [spec, small], example=samples[0],
                                  device="cpu", warm=False).install_executables(
            {(128, 256, 7): fn})
    # an executable that fails its warm-up at its shape is not installed
    with pytest.raises(ValueError, match="exported at"):
        eng.install_executables({(64, 128, 4): fn})
    assert eng._exec == before and eng.warm_runs == 2
    # extending a complete map with the artifact's shape is accepted
    eng.install_executables({(128, 256, 7): fn})
    assert eng._exec[(128, 256, 7)] is fn and eng.warm_runs == 3
    eng.close()


def _serve(port, eng, samples, budgets):
    bat = port.batcher.DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
    reqs = [bat.submit(s) for s in samples]
    bat.close()
    eng.process(bat)
    return [r.result for r in reqs]


def test_install_executables_failing_midway_and_again(port, schnet):
    """A map whose second executable fails its warm-up leaves the engine
    serving as before (executables, warm-up counts and timings); a second
    complete install replaces the first."""
    samples, model, cfg, spec, first, _, blob, _ = schnet
    small = port.graph.PackSpec(num_nodes=64, num_edges=128, num_graphs=4)
    budgets = [spec, small]
    eng = port.engine.ServingEngine(model, cfg, None, budgets, example=samples[0],
                                    device="cpu")
    want = _serve(port, eng, samples[:6], budgets)
    fn = port.export.load_exported(blob, device="cpu")
    live = port.export.make_forward(model, cfg)
    calls = []

    def broken(batch):
        calls.append(batch.num_nodes)
        raise RuntimeError("warm-up refused")

    before = (dict(eng._exec), eng.warm_runs, dict(eng.warmup_ms))
    with pytest.raises(RuntimeError, match="warm-up refused"):
        eng.install_executables({(128, 256, 7): fn, (64, 128, 4): broken})
    assert calls == [64]
    assert (eng._exec, eng.warm_runs, eng.warmup_ms) == before
    for got, ref in zip(_serve(port, eng, samples[:6], budgets), want):
        _equal(got, ref)
    for round_ in (1, 2):
        eng.install_executables({(128, 256, 7): fn, (64, 128, 4): live})
        assert eng._exec == {(128, 256, 7): fn, (64, 128, 4): live}
        assert eng.warm_runs == 2 + 2 * round_
        for got, ref in zip(_serve(port, eng, samples[:6], budgets), want):
            _equal(got, ref)
    eng.close()


# ----------------------------------------------------------------------
# ensure_fields: one batch structure for a mixed dataset
# ----------------------------------------------------------------------

SAMPLE_FIELDS = ("x", "pos", "edge_index", "edge_attr", "edge_shifts", "y_graph", "y_node",
                 "graph_attr", "cell")
# name -> (ensure_fields, the segment plan, a periodic sample in the batch)
ENSURE_CASES = {
    "absent": ({"edge_attr": 2, "edge_shifts": 3, "graph_attr": 4, "y_node": 1, "cell": 9},
               False, False),
    "mixed": ({"edge_attr": 2, "edge_shifts": 3, "cell": 9}, True, True),
}


def _ensure_samples(periodic, n=6, seed=8):
    """The JAX package's request samples; with ``periodic`` the second
    carries a cell and integer-image edge shifts."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(jloadgen.synthetic_request_samples("qm9", n, seed=seed)):
        extra = {}
        if periodic and i == 1:
            extra = dict(
                cell=(5.0 * np.eye(3) + 0.1 * rng.normal(size=(3, 3))).astype(np.float32),
                edge_shifts=rng.integers(-1, 2, size=(s.num_edges, 3)).astype(np.float32),
            )
        out.append(jgraph.GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index,
                                      y_graph=s.y_graph, **extra))
    return out


@pytest.mark.parametrize("case", sorted(ENSURE_CASES))
def test_collate_ensure_fields_matches_jax(port, case):
    """Every field of the port's batch, the zero-filled ones and the
    identity ``cell`` included, equals the JAX package's bit for bit (the
    plan at the TPU's tiles, as the JAX collate plans)."""
    import dataclasses

    ensure, plan, periodic = ENSURE_CASES[case]
    js = _ensure_samples(periodic)
    ts = [port.graph.GraphSample(**{f: getattr(s, f) for f in SAMPLE_FIELDS}) for s in js]
    pad = jgraph.PadSpec.for_samples(js)
    jb = jgraph.collate(js, pad, with_segment_plan=plan, ensure_fields=ensure,
                        as_numpy=True)
    tb = port.graph.collate(
        ts, port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs),
        with_segment_plan=plan, be=512, bn=256, ensure_fields=ensure, as_numpy=True,
    )
    got = tb.arrays()
    assert set(ensure) <= set(got)
    for f in dataclasses.fields(tb):
        if f.name == "seg_tile":
            continue
        jv = getattr(jb, f.name, None)
        if jv is None:
            assert f.name not in got, f.name
            continue
        jv = np.asarray(jv)
        assert jv.dtype == got[f.name].dtype, f.name
        np.testing.assert_array_equal(jv, got[f.name], err_msg=f.name)
    eye = np.tile(np.eye(3, dtype=np.float32), (pad.num_graphs, 1, 1))
    if periodic:
        eye[1] = js[1].cell
    np.testing.assert_array_equal(got["cell"], eye)


def test_engine_serves_with_ensure_fields(port, schnet):
    """A periodic example (a cell, edge shifts) fixes the batch structure;
    molecules without either are served through ``ensure_fields`` with
    both present in every bin, and equal an engine without them bit for
    bit (zero shifts move no edge)."""
    samples, model, cfg, spec, *_ = schnet
    rng = np.random.default_rng(2)
    base = samples[0]
    example = port.graph.GraphSample(
        x=base.x, pos=base.pos, edge_index=base.edge_index, cell=np.eye(3, dtype=np.float32),
        edge_shifts=rng.integers(-1, 2, size=(base.num_edges, 3)).astype(np.float32))
    bare = [port.graph.GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index)
            for s in samples[1:7]]
    ensured = port.engine.ServingEngine(model, cfg, None, [spec], example=example,
                                        ensure_fields={"edge_shifts": 3, "cell": 9},
                                        device="cpu")
    plain = port.engine.ServingEngine(model, cfg, None, [spec], example=bare[0], device="cpu")
    arrays = ensured.collate_bin(bare[:3], spec).arrays()
    assert not arrays["edge_shifts"].any() and arrays["cell"].shape == (spec.num_graphs, 3, 3)
    assert "cell" not in plain.collate_bin(bare[:3], spec).arrays()
    for got, ref in zip(_serve(port, ensured, bare, [spec]), _serve(port, plain, bare, [spec])):
        _equal(got, ref)
    ensured.close()
    plain.close()


# ----------------------------------------------------------------------
# The MLIP form (PaiNN) against the JAX package
# ----------------------------------------------------------------------


def _painn_cfg(spec):
    """md17.json's stack (PaiNN, graph energy head, sum pooling) at the
    small width of tests/test_interatomic_potential.py."""
    return spec.ModelConfig(
        mpnn_type="PAINN", input_dim=1, hidden_dim=16, num_conv_layers=2,
        heads=(spec.HeadSpec("energy", "graph", 1),),
        graph_branches=(spec.BranchSpec(),), node_branches=(spec.BranchSpec(),),
        task_weights=(1.0,), radius=2.5, num_gaussians=8, num_filters=16,
        num_radial=6, graph_pooling="add", enable_interatomic_potential=True,
        energy_weight=1.0, energy_peratom_weight=0.5, force_weight=10.0,
    )


def _to_port(port, samples):
    return [port.graph.GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index,
                                   energy=s.energy, forces=s.forces) for s in samples]


@pytest.fixture(scope="module")
def painn(port):
    """The JAX PaiNN potential's parameters and its (energies, forces) on a
    planned batch of four molecules at a fitted serving budget (one
    compile each, at XLA's lowest backend optimisation for the
    initializer); the port's model carrying the same weights; the budget
    and the port's MLIP artifact exported at it."""
    js = mock_molecular_samples(n_graphs=4, seed=0)
    tsamples = _to_port(port, js)
    ns, es = port.padschedule.dataset_size_arrays(tsamples)
    st = port.engine.ServingSettings(enabled=True, batch_size=4, max_budgets=1)
    (budget,) = port.engine.fit_serving_budgets(ns, es, st)
    jb = jgraph.collate(js, jgraph.PadSpec(budget.num_nodes, budget.num_edges,
                                           budget.num_graphs), with_segment_plan=True)
    jcfg = _painn_cfg(jspec)
    jmodel = jcreate_model(jcfg)
    init = jax.jit(lambda b: init_params(jmodel, b, seed=0)[0])
    params = init.lower(jb).compile({"xla_backend_optimization_level": 0})(jb)
    variables = {"params": params, "batch_stats": {}}
    want = jax.device_get(jax.jit(jax_make_forward(jmodel, jcfg, variables,
                                                   with_forces=True))(jb))
    tcfg = _painn_cfg(port.spec)
    tmodel = port.create.create_model(tcfg, "cpu")
    tmodel.load_state_dict(port.convert.params_from_jax(jax.device_get(params)))
    tb = port.graph.collate(tsamples, budget.pad_spec(), with_segment_plan=True)
    np.testing.assert_array_equal(np.asarray(jb.receivers), tb.receivers.numpy())
    blob = port.export.export_inference(tmodel, tcfg, None, tb, with_forces=True,
                                        devices=["cpu"])
    return tsamples, tmodel, tcfg, tb, want, st, budget, blob


@pytest.mark.parametrize("form", ["make_forward", "artifact"])
def test_with_forces_matches_jax(port, painn, form):
    tsamples, tmodel, tcfg, tb, (want_e, want_f), _, _, blob = painn
    if form == "make_forward":
        fn = port.export.make_forward(tmodel, tcfg, with_forces=True)
    else:
        fn = port.export.load_exported(blob, device="cpu")
        assert fn.info["with_forces"]
    got_e, got_f = fn(tb)
    assert not got_e.requires_grad and not got_f.requires_grad
    assert got_e.shape == want_e.shape and got_f.shape == want_f.shape
    real_g = np.asarray(tb.graph_mask)
    real_n = np.asarray(tb.node_mask)
    _assert_close(got_e.numpy()[real_g], np.asarray(want_e)[real_g], F32_TOL, "energies")
    _assert_close(got_f.numpy()[real_n], np.asarray(want_f)[real_n], GRAD_TOL, "forces")
    assert not got_f.numpy()[~real_n].any()


def test_served_forces_equal_direct_and_artifact_engine(port, painn):
    """A ``with_forces`` engine's energies and forces equal a direct
    ``energy_and_forces(create_graph=False)`` at each bin bit for bit; an
    engine serving the exported MLIP artifact per budget equals it."""
    tsamples, tmodel, tcfg, _, _, st, budget, blob = painn
    torch = port.torch
    budgets = [budget]
    live = port.engine.ServingEngine(tmodel, tcfg, None, budgets, example=tsamples[0],
                                     settings=st, with_forces=True, device="cpu")
    artifacts = {(budget.num_nodes, budget.num_edges, budget.num_graphs): blob}
    offline = port.engine.ServingEngine(tmodel, tcfg, None, budgets, example=tsamples[0],
                                        settings=st, with_forces=True, warm=False,
                                        device="cpu")
    offline.install_executables(port.engine.ServingEngine.from_exported(artifacts,
                                                                        device="cpu"))
    results = []
    for eng in (live, offline):
        reqs, records = [], []
        # two bins: three molecules, then one alone
        for group in (tsamples[:3], tsamples[3:]):
            bat = port.batcher.DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
            reqs += [bat.submit(s) for s in group]
            bat.close()
            records += eng.process(bat)
        results.append((reqs, records))
    (reqs, records), (reqs2, _) = results
    assert all(r.result[0].shape == () and r.result[1].shape == (s.num_nodes, 3)
               for r, s in zip(reqs, tsamples))
    for rec in records:
        batch = live.collate_bin([q.sample for q in rec["reqs"]], rec["spec"]).to("cpu")
        ge, forces = port.mlip.energy_and_forces(tmodel, batch, tcfg, create_graph=False)
        for gi, q in enumerate(rec["reqs"]):
            off, n = rec["offsets"][gi]
            np.testing.assert_array_equal(q.result[0], ge.detach().numpy()[gi])
            np.testing.assert_array_equal(q.result[1], forces.numpy()[off:off + n])
    for a, b in zip(reqs, reqs2):
        for x, y in zip(a.result, b.result):
            np.testing.assert_array_equal(x, y)
    roll = live.rollup(emit=False)
    assert roll["t"] == "serve_rollup" and roll["requests"] == len(tsamples)
    assert live.model is not tmodel
    for p, q in zip(live.model.parameters(), tmodel.parameters()):
        assert torch.equal(p, q)


# ----------------------------------------------------------------------
# The export CLI
# ----------------------------------------------------------------------


def test_export_cli_from_a_run_training_checkpoint(port, tmp_path, monkeypatch, capsys):
    """run_training saves logs/<run>/checkpoint.pt; the CLI restores it,
    exports the first test batch's shape and prints the JAX CLI's line;
    the artifact equals the trained model on that batch bit for bit."""
    _export_cli_case(port, tmp_path, monkeypatch, capsys, "pt")


def test_export_cli_from_a_sharded_checkpoint(port, tmp_path, monkeypatch, capsys):
    """The same with ``checkpoint_format: "orbax"``: run_training writes
    the sharded ``orbax/final`` (and no ``checkpoint.pt``), which the CLI
    restores by the config's key."""
    _export_cli_case(port, tmp_path, monkeypatch, capsys, "orbax")


def _export_cli_case(port, tmp_path, monkeypatch, capsys, fmt):
    import hydragnn_tpu_torch as hg
    from hydragnn_tpu_torch.data.loader import GraphLoader
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data
    from hydragnn_tpu_torch.runner import _ingest_datasets

    monkeypatch.chdir(tmp_path)
    deterministic_graph_data("dataset/demo", number_configurations=40, seed=1)
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as fh:
        config = json.load(fh)
    config["Dataset"]["path"] = {"total": "dataset/demo"}
    config["NeuralNetwork"]["Training"]["num_epoch"] = 1
    config["NeuralNetwork"]["Training"]["batch_size"] = 8
    config["NeuralNetwork"]["Training"]["checkpoint_format"] = fmt
    with open("config.json", "w") as fh:
        json.dump(config, fh)
    state, model, cfg, _, full = hg.run_training(config, device="cpu")
    run = os.path.join("logs", full["_log_name"])
    assert os.path.isdir(os.path.join(run, "orbax", "final")) == (fmt == "orbax")
    assert os.path.exists(os.path.join(run, "checkpoint.pt")) == (fmt == "pt")
    capsys.readouterr()
    port.export.main(["config.json", "out/model.pt2z", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["artifact"] == "out/model.pt2z" and not line["with_forces"]
    assert line["bytes"] == os.path.getsize("out/model.pt2z")
    _, _, testset = _ingest_datasets(full)
    batch = next(iter(GraphLoader(testset, 8, with_segment_plan=True)))
    assert line["batch_shapes"] == {"nodes": batch.num_nodes, "edges": batch.num_edges,
                                    "graphs": batch.num_graphs}
    fn = port.export.load_exported("out/model.pt2z", device="cpu")
    _equal(fn(batch), port.export.make_forward(state.model, cfg)(batch))
