"""DimeNet++ and its host triplets against the JAX package.

Data: examples/qm7x/train.py's molecules (examples/common/molecules.py's
``random_molecule_frames``: HCNOS molecules of 4-11 atoms, radius 4.0,
24 neighbours, one-hot features), made by the JAX package's numpy
neighbour path and handed to both packages as the same numpy arrays.

Bit for bit: ``build_triplets``, ``count_triplets``, ``fill_triplets``,
``PadSpec.for_samples(with_triplets=True)``, collated
``t_kj``/``t_ji``/``triplet_mask`` (with and without the block plan),
the qm7x loader's epoch (its plan and every batch's triplet arrays, on
the worst-case pad run_training takes and on the ladder), the float64
Bessel roots and Chebyshev coefficients, and chip_smoke.py's jax-free
copy of the data.

At f32 rtol 1e-5 / atol 1e-4 x max|ref|: ``bessel_basis_envelope`` and
``spherical_basis`` (padding triplets included), the DimeNet forward
(graph output and the encoder's node representations). At the gradient
tolerance rtol 1e-4 / atol 1e-3 x max|ref|: one AdamW step's loss,
gradients and updated parameters. The model is qm7x.json's DimeNet at
test widths (hidden 16, 2 layers, int_emb 16, basis_emb 4, out_emb 8),
its parameters drawn in numpy on ``jax.eval_shape``'s tree and carried
into the port with ``params_from_jax``; one compiled JAX call gives every
reference.

Then run_training and run_prediction of qm7x.json (small) on the CPU:
triplets in every batch, packing refused as the JAX runner refuses it;
and (``slow``) the port's DimeNet to tests/test_graphs.py's 0.50 / 0.50
on the BCC set.
"""

import copy
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp

from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data.loader import GraphLoader as JGraphLoader
from hydragnn_tpu.data.loader import split_dataset as jsplit_dataset
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.ops import sbf as jsbf
from hydragnn_tpu.train.losses import multihead_loss
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
TRAINING = {"Optimizer": {"type": "AdamW", "learning_rate": 1e-3}}
SIZES = dict(num_radial=6, num_spherical=7, envelope_exponent=5, int_emb_size=16,
             basis_emb_size=4, out_emb_size=8, num_before_skip=1, num_after_skip=2)


def _assert_close(got, want, tol, name="", scale=None):
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    if not np.abs(want).any():
        assert not np.abs(got).any(), name
        return
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * min(scale, 1.0), err_msg=name)


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph, loader
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.ops import sbf
    from hydragnn_tpu_torch.train import loop, optimizer

    return types.SimpleNamespace(torch=torch, runner=runner, graph=graph, loader=loader,
                                 convert=convert, create=create, spec=spec, sbf=sbf,
                                 loop=loop, optimizer=optimizer)


@pytest.fixture(autouse=True)
def numpy_neighbours(monkeypatch):
    """The JAX package's numpy neighbour path (its native cell list finds
    the same edges in another order)."""
    monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")


def _frames(n):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        from common.molecules import random_molecule_frames
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    return random_molecule_frames(n, species=(1, 6, 7, 8, 16), n_atoms_range=(4, 12),
                                  n_molecules=14, seed=7, feature="onehot")


@pytest.fixture(scope="module")
def samples():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
        return _frames(80)


def _to_port(port, samples):
    fields = [f.name for f in dataclasses.fields(port.graph.GraphSample)]
    return [port.graph.GraphSample(**{f: getattr(s, f) for f in fields}) for s in samples]


def _spec_tuple(s):
    return None if s is None else (s.num_nodes, s.num_edges, s.num_graphs, s.num_triplets)


# ------------------------------------------------------------------ host


def test_triplet_functions_match_jax(port, samples):
    """build_triplets and count_triplets per sample, a graph without
    edges, and fill_triplets into a padded buffer: the same arrays."""
    for s in samples[:20]:
        snd, rcv = s.edge_index
        want = jgraph.build_triplets(snd, rcv, s.num_nodes)
        got = port.graph.build_triplets(snd, rcv, s.num_nodes)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert port.graph.count_triplets(_to_port(port, [s])[0]) == jgraph.count_triplets(s)
        assert len(got[0]) == jgraph.count_triplets(s) > 0
    empty = np.zeros(0, np.int64)
    assert all(len(a) == 0 for a in port.graph.build_triplets(empty, empty, 3))
    snd, rcv = samples[0].edge_index
    e = len(snd) + 4
    bufs = {}
    for name, mod in (("jax", jgraph), ("port", port.graph)):
        t = [np.empty(400, np.int32), np.empty(400, np.int32), np.empty(400, bool)]
        s_pad = np.concatenate([snd, np.full(4, 99)]).astype(np.int32)
        r_pad = np.concatenate([rcv, np.full(4, 99)]).astype(np.int32)
        mod.fill_triplets(*t, s_pad, r_pad, len(snd), samples[0].num_nodes)
        bufs[name] = t
    for g, w in zip(bufs["port"], bufs["jax"]):
        np.testing.assert_array_equal(g, w)
    assert bufs["port"][0][-1] == e - 1 and not bufs["port"][2][-1]
    with pytest.raises(ValueError, match="PadSpec too small"):
        port.graph.fill_triplets(np.empty(2, np.int32), np.empty(2, np.int32),
                                 np.empty(2, bool), snd, rcv, len(snd), samples[0].num_nodes)


@pytest.mark.parametrize("plan", [False, True])
def test_padspec_and_collate_triplets_match_jax(port, samples, plan):
    """PadSpec.for_samples(with_triplets=True) on batches of 1, 7 and 32
    molecules, and the collated t_kj / t_ji / triplet_mask (triplets
    index the edges after the plan's sort) equal the JAX package's."""
    js = samples[:32]
    ts = _to_port(port, js)
    for n in (1, 7, 32):
        want = jgraph.PadSpec.for_samples(js[:n], with_triplets=True)
        got = port.graph.PadSpec.for_samples(ts[:n], with_triplets=True)
        assert _spec_tuple(got) == _spec_tuple(want)
    assert port.graph.PadSpec.for_samples(ts).num_triplets is None
    pad = jgraph.PadSpec.for_samples(js, with_triplets=True)
    jb = jgraph.collate(js, pad, with_segment_plan=plan, as_numpy=True)
    tb = port.graph.collate(ts, port.graph.PadSpec(*_spec_tuple(pad)),
                            with_segment_plan=plan, as_numpy=True)
    for name in ("t_kj", "t_ji", "triplet_mask", "senders", "receivers", "edge_mask"):
        g, w = getattr(tb, name), np.asarray(getattr(jb, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert tb.triplet_mask.sum() < pad.num_triplets
    assert port.graph.collate(ts[:4]).t_kj is None


@pytest.mark.parametrize("fixed_pad", ["auto", False])
def test_qm7x_loader_epoch_matches_jax(port, samples, fixed_pad):
    """The qm7x train loader with triplets (batch 32, shuffled, seed 0):
    "auto" resolves to the worst-case pad as in the JAX package; the
    ladder (False) derives each batch's spec at collate time. The epoch
    plan, every batch's padded shape and its triplet arrays equal the
    JAX loader's; packing with triplets is refused with its message."""
    train = jsplit_dataset(samples, 0.8)[0]
    kw = dict(shuffle=True, seed=0, fixed_pad=fixed_pad, with_triplets=True)
    jl = JGraphLoader(train, 32, with_segment_plan=True, **kw)
    tl = port.loader.GraphLoader(_to_port(port, train), 32, **kw)
    assert tl.fixed_pad == jl.fixed_pad == (fixed_pad == "auto")
    assert _spec_tuple(tl.pad_spec) == _spec_tuple(jl.pad_spec)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jplan, tplan = list(jl.epoch_plan(epoch)), list(tl.epoch_plan(epoch))
        assert [(list(i), _spec_tuple(s)) for i, s in tplan] == \
            [(list(i), _spec_tuple(s)) for i, s in jplan]
        for jb, tb in zip(jl, tl):
            assert (tb.num_nodes, tb.num_edges, tb.num_graphs, tb.t_kj.shape[0]) == \
                (jb.num_nodes, jb.num_edges, jb.num_graphs, jb.t_kj.shape[0])
            for name in ("t_kj", "t_ji", "triplet_mask"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)), err_msg=name)
    with pytest.raises(ValueError, match="packing budgets do not cover triplet counts"):
        port.loader.GraphLoader(_to_port(port, train), 32, packing=True, with_triplets=True)


def test_superstep_groups_and_step_keys_with_triplets(port, samples):
    """Superstep grouping of a triplet loader's plans equals the JAX
    package's: the ladder's spec-less entries are never grouped, the
    worst-case pad's are; a step graph's key holds the triplet count."""
    from hydragnn_tpu.data.padschedule import superstep_groups as jgroups

    from hydragnn_tpu_torch.data.padschedule import superstep_groups

    train = _to_port(port, jsplit_dataset(samples, 0.8)[0])
    for fixed_pad in ("auto", False):
        loader = port.loader.GraphLoader(train, 16, shuffle=True, seed=0,
                                         fixed_pad=fixed_pad, with_triplets=True)
        plan = list(loader.epoch_plan(0))
        got = [[list(i) for i, _ in g] for g in superstep_groups(plan, 2)]
        want = [[list(i) for i, _ in g] for g in jgroups(plan, 2)]
        assert got == want
        assert max(map(len, got)) == (2 if fixed_pad == "auto" else 1)
    batch = loader.collate_entry(*plan[0])
    assert port.loop._spec_key(batch) == (batch.num_nodes, batch.num_edges,
                                          batch.num_graphs, batch.t_kj.shape[0])


def test_bessel_roots_and_chebyshev_table_match_jax(port):
    """The float64 host tables, bit for bit, at qm7x.json's sizes and at
    another."""
    for s, r in ((7, 6), (3, 4)):
        np.testing.assert_array_equal(port.sbf.spherical_bessel_roots(s, r),
                                      jsbf.spherical_bessel_roots(s, r))
        got, want = port.sbf._radial_cheb_coeffs(s, r), jsbf._radial_cheb_coeffs(s, r)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_chip_smoke_qm7x_frames_match_example(port, samples):
    """chip_smoke.py's jax-free copy of the qm7x data (the port's
    radius graph) equals the example's samples array for array."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.qm7x_frames(len(samples))
    for g, w in zip(got, samples):
        for f in ("x", "pos", "edge_index", "forces", "y_graph"):
            gv, wv = getattr(g, f), getattr(w, f)
            assert np.asarray(gv).dtype == np.asarray(wv).dtype, f
            np.testing.assert_array_equal(gv, wv, err_msg=f)
        assert g.energy == w.energy


# ------------------------------------------------------------------ model


def _cfg(spec, hidden=16):
    """qm7x.json's DimeNet (graph head 1 x hidden + [hidden, hidden], add
    pooling) at test widths."""
    return spec.ModelConfig(
        mpnn_type="DimeNet", input_dim=5, hidden_dim=hidden, num_conv_layers=2,
        heads=(spec.HeadSpec("energy", "graph", 1),),
        graph_branches=(spec.BranchSpec(num_sharedlayers=1, dim_sharedlayers=hidden,
                                        num_headlayers=2,
                                        dim_headlayers=(hidden, hidden)),),
        node_branches=(spec.BranchSpec(),), task_weights=(1.0,), radius=4.0,
        max_neighbours=24, graph_pooling="add", **SIZES,
    )


def _fill(tree, rng):
    """Seeded numpy values for a flax params shape tree: kernels normal /
    sqrt(fan-in), biases small and nonzero."""

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def batches(port, samples):
    """16 molecules padded with spare nodes, edges and triplets (so
    padding triplets index the padding node's self-loop slot), with the
    block plan, as JAX and port batches."""
    js = [dataclasses.replace(s, x=np.ascontiguousarray(s.x[:, :5])) for s in samples[:16]]
    pad = jgraph.PadSpec.for_samples(js, with_triplets=True)
    pad = jgraph.PadSpec(pad.num_nodes + 8, pad.num_edges + 16, pad.num_graphs + 1,
                         pad.num_triplets + 64)
    jb = jgraph.collate(js, pad, with_segment_plan=True)
    tb = port.graph.collate(_to_port(port, js), port.graph.PadSpec(*_spec_tuple(pad)),
                            with_segment_plan=True)
    np.testing.assert_array_equal(tb.t_kj.numpy(), np.asarray(jb.t_kj))
    return jb, tb


SBF_D = np.array([0.0, 1e-9, 0.3, 1.1, 2.05, 3.3, 3.999, 4.0, 5.2], np.float32)


@pytest.fixture(scope="module")
def reference(batches):
    """One compiled call: the DimeNet forward (head output and encoder
    nodes), one AdamW step (loss, gradients, updated parameters), and
    the bases on the batch's edges and triplets and on SBF_D."""
    jb, _ = batches
    cfg = _cfg(jspec)
    model = jcreate_model(cfg)
    tx = jselect_optimizer(TRAINING)
    shapes = jax.eval_shape(lambda b: init_params(model, b, seed=0)[0], jb)
    params = _fill(shapes, np.random.default_rng(7))
    angle = np.random.default_rng(8).uniform(0, np.pi, len(SBF_D)).astype(np.float32)

    def run(params, batch):
        variables = {"params": params, "batch_stats": {}}
        out = model.apply(variables, batch)
        nodes = model.apply(variables, batch, method=model.encode)[0]

        def loss(p):
            return multihead_loss(model.apply({"params": p, "batch_stats": {}}, batch),
                                  batch, cfg)[0]

        tot, grads = jax.value_and_grad(loss)(params)
        new = create_train_state(params, tx).apply_gradients(grads, tx)
        d = jnp.asarray(SBF_D)
        ops = {
            "rbf": jsbf.bessel_basis_envelope(d, 4.0, 6, 5),
            "sbf": jsbf.spherical_basis(d, jnp.asarray(angle), jnp.arange(len(SBF_D)),
                                        cutoff=4.0, num_spherical=7, num_radial=6),
        }
        return out, nodes, tot, grads, new.params, ops

    run = jax.jit(run).lower(params, jb).compile({"xla_backend_optimization_level": 0})
    return jax.device_get(run(params, jb)), params, angle


def _port_model(port, params):
    model = port.create.create_model(_cfg(port.spec), "cpu")
    model.load_state_dict(port.convert.params_from_jax(params))
    return model


def test_bases_match_jax(port, reference):
    """bessel_basis_envelope and spherical_basis at lengths from 0 (a
    padding edge) past the cutoff."""
    (_, _, _, _, _, ops), _, angle = reference
    torch = port.torch
    d = torch.from_numpy(SBF_D)
    cheb = torch.tensor(port.sbf._radial_cheb_coeffs(7, 6))
    got_rbf = port.sbf.bessel_basis_envelope(d, 4.0, 6, 5).numpy()
    got_sbf = port.sbf.spherical_basis(d, torch.from_numpy(angle), torch.arange(len(SBF_D)),
                                       cheb, cutoff=4.0, num_spherical=7, num_radial=6).numpy()
    for name, got in (("rbf", got_rbf), ("sbf", got_sbf)):
        assert got.shape == ops[name].shape and np.isfinite(got).all()
        _assert_close(got, ops[name], F32_TOL, name)


def test_dimenet_forward_matches_flax(port, batches, reference):
    """The graph head's output and the encoder's node representations
    equal flax's on the real graphs and nodes."""
    _, tb = batches
    (out, nodes, *_), params, _ = reference
    model = _port_model(port, params)
    with port.torch.no_grad():
        got = model(tb)[0]
        got_nodes = model.encode(tb)[0]
    gm, nm = tb.graph_mask.numpy(), tb.node_mask.numpy()
    _assert_close(got.numpy()[gm], np.asarray(out[0])[gm], F32_TOL, "graph output")
    _assert_close(got_nodes.numpy()[nm], np.asarray(nodes)[nm], F32_TOL, "encoder nodes")


def test_dimenet_train_step_matches_jax(port, batches, reference):
    """One AdamW step of make_train_step: loss, every gradient (no NaN
    from the padding triplets' zero vectors) and every updated
    parameter."""
    _, tb = batches
    (_, _, j_tot, j_grads, j_new, _), params, _ = reference
    model = _port_model(port, params)
    opt = port.optimizer.select_optimizer(model.parameters(), TRAINING)
    step = port.loop.make_train_step(model, opt, model.cfg)
    _, tot, _ = step(port.loop.TrainState(model, opt), tb)
    _assert_close(tot.numpy(), j_tot, GRAD_TOL, "loss")
    want_g = port.convert.params_from_jax(j_grads)
    want_p = port.convert.params_from_jax(j_new)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    for name, p in named.items():
        assert np.isfinite(p.grad.numpy()).all(), name
        _assert_close(p.grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}")
        _assert_close(p.detach().numpy(), want_p[name].numpy(), GRAD_TOL, f"param {name}")


def test_dimenet_refuses_batches_without_triplets(port, batches, reference):
    _, tb = batches
    model = _port_model(port, reference[1])
    with pytest.raises(ValueError, match="requires triplets"):
        model(dataclasses.replace(tb, t_kj=None))


# ------------------------------------------------------------------ runner


def _qm7x_config(epochs=1, packing="auto"):
    """examples/qm7x/qm7x.json at test widths (hidden 16, int_emb 16),
    batch 16."""
    with open(os.path.join(ROOT, "examples", "qm7x", "qm7x.json")) as f:
        config = json.load(f)
    config["Verbosity"] = {"level": 0}
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, int_emb_size=16, basis_emb_size=4, out_emb_size=8)
    arch["output_heads"]["graph"].update(dim_sharedlayers=16, dim_headlayers=[16, 16])
    config["NeuralNetwork"]["Training"].update(
        num_epoch=epochs, batch_size=16,
        Parallelism={"scheme": "single", "packing": {"enabled": packing}})
    return config


def test_qm7x_run_training_and_prediction(port, samples, monkeypatch, tmp_path, capsys):
    """run_training then run_prediction of qm7x.json on the CPU: every
    train batch carries triplets on the worst-case pad, losses and
    predictions are finite, and packing named on is refused with the
    JAX runner's message."""
    monkeypatch.chdir(tmp_path)
    splits = tuple(_to_port(port, s) for s in jsplit_dataset(samples[:48], 0.8))
    shapes = []
    plain = port.loop._dispatch

    def spy(run, graphs, key, batches, device):
        shapes.extend(port.loop._spec_key(b) for b in batches)
        return plain(run, graphs, key, batches, device)

    monkeypatch.setattr(port.loop, "_dispatch", spy)
    config = _qm7x_config(packing=True)
    config["Verbosity"] = {"level": 1}
    state, model, cfg, hist, full = port.runner.run_training(config, datasets=splits,
                                                             device="cpu")
    assert "packing ignored: packing budgets do not cover triplet counts" in \
        capsys.readouterr().out
    assert shapes and all(s[3] is not None for s in shapes)
    assert len({s for s in shapes[:state.step]}) == 1  # one worst-case train shape
    err, _, trues, preds = port.runner.run_prediction(full, datasets=splits, state=state,
                                                      model=model, cfg=cfg)
    assert np.isfinite(hist.train_loss + hist.val_loss + [err]).all()
    assert preds[0].shape == trues[0].shape == (len(splits[2]), 1)
    assert np.isfinite(preds[0]).all()


@pytest.mark.slow
def test_dimenet_trains_to_threshold(port, tmp_path, monkeypatch):
    """The port's DimeNet on tests/test_graphs.py's BCC set (300
    configurations, seed 7, ci.json) reaches 0.50 / 0.50 (head RMSE,
    sample MAE), trained by run_training and predicted by
    run_prediction(config) alone from the run's checkpoint."""
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "dataset" / "unit_test")
    deterministic_graph_data(path, number_configurations=300, seed=7)
    with open(os.path.join(ROOT, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"]["path"] = {"total": path}
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = "DimeNet"
    config["NeuralNetwork"]["Training"]["Parallelism"] = {"scheme": "single"}
    port.runner.run_training(copy.deepcopy(config), device="cpu")
    _, _, trues, preds = port.runner.run_prediction(config, device="cpu")
    for t, p in zip(trues, preds):
        assert float(np.sqrt(np.mean((t - p) ** 2))) < 0.50
        assert float(np.mean(np.abs(t - p))) < 0.50
