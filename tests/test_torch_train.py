"""The training slice against the JAX package: SchNet trained on the CPU.

- host side, bit for bit: ``deterministic_graph_data`` files,
  ``process_raw_samples`` arrays (the JAX package's numpy neighbour path,
  HYDRAGNN_TPU_NO_NATIVE=1), the stratified ``split_dataset``,
  ``update_config`` on tests/inputs/ci.json, and two epochs of
  ``GraphLoader`` batches with their block plans;
- one train step (loss, every parameter's gradient, the AdamW-updated
  parameters) against JAX's ``make_train_step`` from the same
  parameters (``params_from_jax``), on a planned batch (JAX: the Pallas
  kernels, interpreted, forced with HYDRAGNN_TPU_SEGMENT_IMPL=
  pallas_fused; port: K1/K2's plain versions through K1's operator)
  and on a scatter batch;
- ``run_training(config, device="cpu")`` for two epochs against JAX's
  ``run_training`` from the same initial parameters: per-epoch losses;
- (``slow``) the port's SchNet trained to tests/test_graphs.py:23's
  thresholds.

Model: ci.json's SchNet (2 layers, hidden 16, 32 filters, 50 Gaussians).
Tolerances: f32 forward rtol 1e-5 / atol 1e-4, f32 gradients and
updated parameters rtol 1e-4 / atol 1e-3 (tests/test_pallas_segment.py
:341 and :808), each atol scaled by the reference's largest magnitude
where that is below 1, with that magnitude asserted.
"""

import copy
import os
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax

import hydragnn_tpu
from hydragnn_tpu import runner as jrunner
from hydragnn_tpu.config import load_config as jload_config
from hydragnn_tpu.config import update_config as jupdate_config
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import loader as jloader
from hydragnn_tpu.data import raw as jraw
from hydragnn_tpu.data.synthetic import deterministic_graph_data as jdgd
from hydragnn_tpu.models.create import create_model_config as jcreate
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.ops import pallas_segment as jps
from hydragnn_tpu.train.loop import make_loss_fn, make_train_step
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import create_train_state

HERE = os.path.dirname(os.path.abspath(__file__))
F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
N_CONFIGS = 40


def _assert_close(got, want, tol, name=""):
    scale = float(np.abs(want).max())
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0),
        err_msg=name,
    )


@pytest.fixture(scope="module")
def port():
    """torch and the port's modules, imported when this file runs rather
    than at collection."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import config, runner
    from hydragnn_tpu_torch.data import graph, loader, raw, synthetic
    from hydragnn_tpu_torch.models import convert, create
    from hydragnn_tpu_torch.ops import edge_pipeline
    from hydragnn_tpu_torch.train import loop, optimizer

    return types.SimpleNamespace(
        torch=torch, config=config, runner=runner, graph=graph, loader=loader,
        raw=raw, synthetic=synthetic, convert=convert, create=create,
        ep=edge_pipeline, loop=loop, optimizer=optimizer,
    )


def _ci_config(path):
    config = jload_config(os.path.join(HERE, "inputs", "ci.json"))
    config["Dataset"]["path"] = {"total": path}
    return config


@pytest.fixture(scope="module")
def data(port, tmp_path_factory):
    """The BCC set written by both packages, and its samples processed by
    both (the JAX package on its numpy neighbour path)."""
    root = tmp_path_factory.mktemp("bcc")
    paths = {k: str(root / k) for k in ("jax", "port")}
    jdgd(paths["jax"], number_configurations=N_CONFIGS, seed=7)
    port.synthetic.deterministic_graph_data(
        paths["port"], number_configurations=N_CONFIGS, seed=7
    )
    config = _ci_config(paths["port"])
    ds = config["Dataset"]
    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    try:
        j_samples = jraw.process_raw_samples(jraw.read_lsms_directory(paths["jax"], ds), config)
    finally:
        mp.undo()
    t_samples = port.raw.process_raw_samples(
        port.raw.read_lsms_directory(paths["port"], ds), config
    )
    return paths, config, j_samples, t_samples


def test_synthetic_files_match(data):
    paths = data[0]
    names = sorted(os.listdir(paths["jax"]))
    assert names == sorted(os.listdir(paths["port"])) and len(names) == N_CONFIGS
    for name in names:
        with open(os.path.join(paths["jax"], name), "rb") as f, open(
            os.path.join(paths["port"], name), "rb"
        ) as g:
            assert f.read() == g.read(), name


def _assert_samples_equal(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for f in ("x", "pos", "edge_index", "y_graph", "y_node"):
            ja, tb = getattr(a, f), getattr(b, f)
            assert (ja is None) == (tb is None), f
            if ja is not None:
                assert ja.dtype == tb.dtype, f
                np.testing.assert_array_equal(ja, tb, err_msg=f)


def test_processed_samples_split_and_config_match(port, data):
    """process_raw_samples, the stratified split and update_config give
    the JAX package's arrays and dict."""
    _, config, js, ts = data
    _assert_samples_equal(js, ts)
    j_split = jloader.split_dataset(js, 0.7, stratified=True)
    t_split = port.loader.split_dataset(ts, 0.7, stratified=True)
    for a, b in zip(j_split, t_split):
        _assert_samples_equal(a, b)
    assert jupdate_config(config, *j_split) == port.config.update_config(config, *t_split)


@pytest.mark.parametrize("fixed_pad", ["auto", True])
def test_loader_batches_match(port, data, fixed_pad):
    """Two shuffled epochs: every collated field equals the JAX loader's,
    and every block plan equals the JAX planner run at the Hopper tiles
    over the same receiver-sorted edges."""
    _, _, js, ts = data
    torch = port.torch
    be, bn = port.ep.DEFAULT_BE, port.ep.DEFAULT_BN
    jl = jloader.GraphLoader(js, 8, shuffle=True, seed=3, fixed_pad=fixed_pad,
                             with_segment_plan=True)
    tl = port.loader.GraphLoader(ts, 8, shuffle=True, seed=3, fixed_pad=fixed_pad)
    assert len(jl) == len(tl) and jl.fixed_pad == tl.fixed_pad
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        pairs = list(zip(jl, tl))
        assert len(pairs) == len(tl)
        for jb, tb in pairs:
            assert isinstance(tb.x, torch.Tensor)
            for name in ("x", "pos", "node_graph_idx", "node_slot", "node_mask",
                         "senders", "receivers", "edge_mask", "graph_mask", "y_graph"):
                jv, tv = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
                assert jv.dtype == tv.dtype, name
                np.testing.assert_array_equal(jv, tv, err_msg=name)
            want = jps.plan_blocks_static(
                np.asarray(jb.receivers), jb.num_nodes,
                jps.static_block_bound(jb.num_edges, jb.num_nodes, be, bn),
                be, bn, edge_valid=np.asarray(jb.edge_mask),
            )
            got = (tb.seg_perm, tb.seg_ids, tb.seg_valid, tb.seg_window)
            for w, g in zip(want, got):
                np.testing.assert_array_equal(w, g.numpy())


@pytest.fixture(scope="module")
def models(port, data):
    """The JAX SchNet of ci.json with its initial parameters, and the
    port's model holding the same parameters."""
    _, config, js, ts = data
    full = jupdate_config(config, *jloader.split_dataset(js, 0.7, stratified=True))
    jmodel, jcfg = jcreate(full)
    # flax init under jit: one compile instead of op-by-op dispatch
    params = jax.device_get(jax.jit(lambda b: init_params(jmodel, b, seed=0)[0])(
        jgraph.collate(js[:4])
    ))
    tmodel, tcfg = port.create.create_model_config(full, "cpu")
    tmodel.load_state_dict(port.convert.params_from_jax(params))
    return full, jmodel, jcfg, params, tmodel, tcfg


@pytest.fixture(scope="module")
def step_case(port, data, models):
    """One batch of 8 graphs collated without and with the block plan by
    both packages, and JAX's step on both in one compiled call: the loss,
    every gradient, and the parameters after one AdamW update of
    make_train_step."""
    _, _, js, ts = data
    full, jmodel, jcfg, params, _, _ = models
    tx = jselect_optimizer(full["NeuralNetwork"]["Training"])
    loss_fn = make_loss_fn(jmodel, jcfg)
    step = make_train_step(jmodel, tx, jcfg, donate=False)
    pad = jgraph.PadSpec.for_samples(js[:8])
    tpad = port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs)
    jbs, tbs = {}, {}
    for planned in (False, True):
        jbs[planned] = jgraph.collate(js[:8], pad, with_segment_plan=planned)
        tbs[planned] = port.graph.collate(ts[:8], tpad, with_segment_plan=planned)

    @jax.jit
    def reference(state, batches):
        out = {}
        for planned, batch in batches.items():
            grads = jax.grad(lambda p: loss_fn(p, {}, batch)[0])(state.params)
            new_state, tot, _ = step(state, batch)
            out[planned] = (tot, grads, new_state.params)
        return out

    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRAGNN_TPU_SEGMENT_IMPL", "pallas_fused")  # read while tracing
    try:
        want = jax.device_get(reference(create_train_state(params, tx), jbs))
    finally:
        mp.undo()
    return tbs, want


@pytest.mark.parametrize("planned", [False, True])
def test_train_step_matches_jax(port, models, step_case, planned):
    """Loss, every gradient and every AdamW-updated parameter of one
    step equal JAX's make_train_step from the same parameters."""
    full, _, _, _, tmodel, tcfg = models
    tbs, want = step_case
    j_loss, j_grads, j_new = want[planned]
    assert (tbs[planned].seg_window is not None) == planned
    model = copy.deepcopy(tmodel)
    opt = port.optimizer.select_optimizer(
        model.parameters(), full["NeuralNetwork"]["Training"]
    )
    t_step = port.loop.make_train_step(model, opt, tcfg)
    k1, k2 = port.ep.edge_pipeline_planned.launches, port.ep.edge_pipeline_bwd_planned.launches
    _, t_loss, _ = t_step(port.loop.TrainState(model, opt), tbs[planned])
    # CPU tensors run the plain versions: no kernel launch
    assert (port.ep.edge_pipeline_planned.launches,
            port.ep.edge_pipeline_bwd_planned.launches) == (k1, k2)
    _assert_close(np.asarray(float(t_loss)), np.asarray(float(j_loss)), F32_TOL, "loss")
    want_g = port.convert.params_from_jax(j_grads)
    want_p = port.convert.params_from_jax(j_new)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    for name, p in named.items():
        _assert_close(p.grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}")
        _assert_close(p.detach().numpy(), want_p[name].numpy(), GRAD_TOL, f"param {name}")


def _run_config(path, epochs):
    config = _ci_config(path)
    training = config["NeuralNetwork"]["Training"]
    training["num_epoch"] = epochs
    training["Parallelism"] = {
        "scheme": "single", "packing": {"enabled": False},
        "superstep": {"steps": 1}, "pipeline": {"workers": 0},
    }
    return config


def test_run_training_matches_jax(port, data, monkeypatch, tmp_path):
    """Two epochs of run_training from the same initial parameters: the
    per-epoch train/val/test losses equal JAX's run_training, and
    run_prediction's error equals the last test loss."""
    paths = data[0]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    # The JAX loop opens a TensorBoard writer when torch's can be
    # imported (pulling in TensorFlow, seconds of import); without one
    # it writes no summaries and trains the same.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    captured = {}

    def spy(model, example, seed=0):
        """init_params under jit (one compile instead of op-by-op
        dispatch), keeping the initial parameters for the port."""
        out = jax.jit(lambda b: init_params(model, b, seed=seed))(example)
        captured["params"] = jax.device_get(out[0])
        return out

    monkeypatch.setattr(jrunner, "init_params", spy)
    _, _, _, j_hist, _ = hydragnn_tpu.run_training(_run_config(paths["jax"], 2))
    sd = port.convert.params_from_jax(captured["params"])
    make = port.runner.create_model_config

    def with_jax_params(config, device=None, *, seed=0):
        model, cfg = make(config, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    monkeypatch.setattr(port.runner, "create_model_config", with_jax_params)
    state, model, cfg, t_hist, full = port.runner.run_training(
        _run_config(paths["port"], 2), device="cpu"
    )
    for name in ("train_loss", "val_loss", "test_loss"):
        _assert_close(np.asarray(getattr(t_hist, name)),
                      np.asarray(getattr(j_hist, name)), GRAD_TOL, name)
    err, tasks, trues, preds = port.runner.run_prediction(
        full, state=state, model=model, cfg=cfg
    )
    assert trues[0].shape == preds[0].shape and np.isfinite(preds[0]).all()
    np.testing.assert_allclose(err, t_hist.test_loss[-1], rtol=1e-6)


@pytest.mark.slow
def test_schnet_trains_to_threshold(port, tmp_path, monkeypatch):
    """The port's SchNet on the 300-configuration BCC set (seed 7) reaches
    tests/test_graphs.py:23's thresholds: head RMSE and sample MAE below
    0.20."""
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "dataset" / "unit_test")
    port.synthetic.deterministic_graph_data(path, number_configurations=300, seed=7)
    config = _ci_config(path)
    state, model, cfg, _, full = port.runner.run_training(config, device="cpu")
    _, _, trues, preds = port.runner.run_prediction(full, state=state, model=model, cfg=cfg)
    for t, p in zip(trues, preds):
        assert float(np.sqrt(np.mean((t - p) ** 2))) < 0.20
        assert float(np.mean(np.abs(t - p))) < 0.20
