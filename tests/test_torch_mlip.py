"""The MLIP slice against the JAX package: PaiNN and SchNet potentials.

Small models as in tests/test_interatomic_potential.py (2 layers, hidden
16, num_radial 6, 8 Gaussians) on its ``mock_molecular_samples`` (four
molecules of 6-10 atoms with energies and forces), collated by both
packages from the same numpy arrays with the block plan attached. The
JAX side runs as its own tests run it on the CPU (the XLA scatter), the
port through K1/K2's plain versions: K1's operator forward and
backward and K2's operator for the force pass's derivative.
Parameters are the JAX package's, carried over with ``params_from_jax``.

- ``sinc_basis`` against JAX, padding lengths included;
- the PaiNN forward against flax;
- ``energy_and_forces`` for a node head and a graph head;
- one ``make_train_step(compute_grad_energy=True)`` step: the loss, the
  three per-task losses, every gradient and every AdamW-updated
  parameter;
- ``train/mlip.py``'s error cases;
- rotating the positions rotates the port's forces and leaves its
  energies unchanged;
- (``slow``) the port's PaiNN potential trains, and two epochs of
  ``run_training`` give JAX's per-epoch losses.

Tolerances (ROADMAP "How parity is judged"): f32 forward rtol 1e-5 /
atol 1e-4, gradients (forces are one) rtol 1e-4 / atol 1e-3, each atol
scaled by the reference's largest magnitude where that is below 1 (the
magnitude asserted, or an exact zero on both sides for a parameter the
loss does not reach). The parameter gradients of one step are scaled by
the largest over all parameters: a gradient of the force loss is a sum
of terms of that size that cancel in some small tensors (PaiNN's
layer-0 U map, a 1 x 1 weight, moves by a few percent between f32 runs
of either package, with or without the plan, against its f64 value), so
its f32 error follows the whole gradient's scale, not its own.
"""

import copy
import dataclasses
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp

import hydragnn_tpu
from hydragnn_tpu import runner as jrunner
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data.loader import split_dataset as jsplit_dataset
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.ops import rbf as jrbf
from hydragnn_tpu.train.mlip import energy_and_forces as jenergy_and_forces
from hydragnn_tpu.train.mlip import energy_force_loss_terms
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import create_train_state

from tests.test_forces_equivariant import _rotation, _sample
from tests.test_interatomic_potential import mock_molecular_samples

F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
TRAINING = {"Optimizer": {"type": "AdamW", "learning_rate": 3e-3}}
# (stack, energy head): md17.json's PaiNN with its graph head (sum
# pooling), SchNet with a node head.
CASES = [("PAINN", "graph"), ("SchNet", "node")]


def _assert_close(got, want, tol, name="", scale=None):
    """``got`` equals ``want`` at ``tol``'s rtol and its atol times
    min(scale, 1), ``scale`` being ``want``'s largest magnitude unless
    given."""
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    if not np.abs(want).any():  # a parameter the loss does not reach
        assert not np.abs(got).any(), name
        return
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
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.ops import edge_pipeline, rbf
    from hydragnn_tpu_torch.train import loop, mlip, optimizer

    return types.SimpleNamespace(
        torch=torch, runner=runner, graph=graph, convert=convert, create=create,
        spec=spec, ep=edge_pipeline, rbf=rbf, loop=loop, mlip=mlip,
        optimizer=optimizer,
    )


def _cfg(spec, mpnn_type, head_type, **kw):
    """tests/test_interatomic_potential.py's ``_mlip_config`` built from
    either package's spec module."""
    return spec.ModelConfig(**{
        **dict(
            mpnn_type=mpnn_type, input_dim=1, hidden_dim=16, num_conv_layers=2,
            heads=(spec.HeadSpec("energy", head_type, 1),),
            graph_branches=(spec.BranchSpec(),), node_branches=(spec.BranchSpec(),),
            task_weights=(1.0,), radius=2.5, num_gaussians=8, num_filters=16,
            num_radial=6, graph_pooling="add" if head_type == "graph" else "mean",
            enable_interatomic_potential=True, energy_weight=1.0,
            energy_peratom_weight=0.5, force_weight=10.0,
        ),
        **kw,
    })


def _to_port(port, samples):
    """The port's GraphSamples holding the same numpy arrays."""
    return [
        port.graph.GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index,
                               energy=s.energy, forces=s.forces)
        for s in samples
    ]


def _port_model(port, tcfg, params):
    model = port.create.create_model(tcfg, "cpu")
    model.load_state_dict(port.convert.params_from_jax(params))
    return model


@pytest.fixture(scope="module")
def batches(port):
    js = mock_molecular_samples(n_graphs=4, seed=0)
    jb = jgraph.collate(js, with_segment_plan=True)
    tb = port.graph.collate(_to_port(port, js), with_segment_plan=True)
    assert tb.seg_window is not None
    np.testing.assert_array_equal(np.asarray(jb.receivers), tb.receivers.numpy())
    return jb, tb


@pytest.fixture(scope="module")
def reference(port, batches):
    """Both cases: JAX's initial parameters (one compile, at XLA's lowest
    backend optimisation: it runs once, and its random-number code
    compiles slowly), then in one more compiled call one step of
    ``make_train_step(compute_grad_energy=True)`` as its body is written
    (the value and gradients of the MLIP loss, then ``apply_gradients``),
    with the loss written out as ``energy_force_loss`` is
    (``energy_and_forces``, then ``energy_force_loss_terms``), so that the
    graph energies (the energy head's forward output) and the forces come
    out of the same compile."""
    jb, _ = batches
    tx = jselect_optimizer(TRAINING)
    models = {case: (jcreate_model(_cfg(jspec, *case)), _cfg(jspec, *case))
              for case in CASES}
    init = jax.jit(lambda batch: {case: init_params(models[case][0], batch, seed=0)[0]
                                  for case in CASES})
    params = init.lower(jb).compile({"xla_backend_optimization_level": 0})(jb)

    def one(model, cfg, params, batch):
        def loss(p):
            variables = {"params": p, "batch_stats": {}}
            ge, forces, _ = jenergy_and_forces(model, variables, batch, cfg, train=True)
            tot, tasks = energy_force_loss_terms(ge, forces, batch, cfg)
            return tot, (tasks, ge, forces)

        (tot, (tasks, ge, forces)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        new_state = create_train_state(params, tx).apply_gradients(grads, tx)
        return params, ge, forces, tot, tasks, grads, new_state.params

    run = jax.jit(lambda params, batch: {case: one(*models[case], params[case], batch)
                                         for case in CASES})
    return jax.device_get(run(params, jb))


def test_sinc_basis_matches_jax(port):
    torch = port.torch
    d = np.array([0.0, 1e-9, 3e-5, 0.4, 1.3, 2.49, 2.5, 3.7], np.float32)
    want = np.asarray(jrbf.sinc_basis(jnp.asarray(d), 2.5, 6))
    got = port.rbf.sinc_basis(torch.from_numpy(d), 2.5, 6).numpy()
    _assert_close(got, want, F32_TOL, "sinc_basis")
    assert np.isfinite(got).all()


def test_painn_forward_matches_flax(port, batches, reference):
    """The PaiNN energy head's output on the planned batch (a plain
    forward, no gradient) equals flax's from the same parameters, on the
    real graphs (flax's graph energies are that output, masked)."""
    _, tb = batches
    want = reference[("PAINN", "graph")]
    model = _port_model(port, _cfg(port.spec, "PAINN", "graph"), want[0])
    with port.torch.no_grad():
        got = model(tb)[0][:, 0]
    gm = tb.graph_mask.numpy()
    assert got.shape == want[1].shape
    _assert_close(got.numpy()[gm], want[1][gm], F32_TOL, "PaiNN graph head")


@pytest.mark.parametrize("mpnn_type,head_type", CASES)
def test_energy_and_forces_match_jax(port, batches, reference, mpnn_type, head_type):
    """Graph energies and forces (-dE/dpos, zero on padding atoms) equal
    JAX's; the plan's CPU path launches no kernel."""
    _, tb = batches
    want = reference[(mpnn_type, head_type)]
    model = _port_model(port, _cfg(port.spec, mpnn_type, head_type), want[0])
    launches = (port.ep.edge_pipeline_planned.launches,
                port.ep.edge_pipeline_bwd_planned.launches)
    ge, forces = port.mlip.energy_and_forces(model, tb, model.cfg)
    assert launches == (port.ep.edge_pipeline_planned.launches,
                        port.ep.edge_pipeline_bwd_planned.launches)
    assert forces.requires_grad  # the force pass stays differentiable
    _assert_close(ge.detach().numpy(), want[1], F32_TOL, "graph energies")
    _assert_close(forces.detach().numpy(), want[2], GRAD_TOL, "forces")
    assert not forces.detach().numpy()[~tb.node_mask.numpy()].any()


@pytest.mark.parametrize("mpnn_type,head_type", CASES)
def test_mlip_train_step_matches_jax(port, batches, reference, mpnn_type, head_type):
    """One AdamW step on the energy + force loss: the loss, the per-task
    losses, every gradient (a second derivative through the force pass)
    and every updated parameter equal JAX's."""
    _, tb = batches
    params, *_, j_tot, j_tasks, j_grads, j_new = reference[(mpnn_type, head_type)]
    model = _port_model(port, _cfg(port.spec, mpnn_type, head_type), params)
    opt = port.optimizer.select_optimizer(model.parameters(), TRAINING)
    step = port.loop.make_train_step(model, opt, model.cfg, compute_grad_energy=True)
    _, tot, tasks = step(port.loop.TrainState(model, opt), tb)
    _assert_close(tot.numpy(), j_tot, F32_TOL, "loss")
    assert tasks.shape == (3,)
    _assert_close(tasks.numpy(), j_tasks, F32_TOL, "per-task losses")
    want_g = port.convert.params_from_jax(j_grads)
    want_p = port.convert.params_from_jax(j_new)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    g_scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in named.items():
        # a parameter the loss does not reach (the node-head model's
        # graph branch) has no .grad; JAX's gradient there is zero
        grad = p.grad if p.grad is not None else port.torch.zeros_like(p)
        _assert_close(grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}",
                      scale=g_scale)
        _assert_close(p.detach().numpy(), want_p[name].numpy(), GRAD_TOL, f"param {name}")


def _error_case(port, tb, case):
    spec = port.spec
    if case == "two_heads":
        heads = (spec.HeadSpec("energy", "graph", 1), spec.HeadSpec("e2", "graph", 1))
        return _cfg(spec, "PAINN", "graph", heads=heads, task_weights=(1.0, 1.0)), tb
    if case == "mean_pooled_graph_head":
        return _cfg(spec, "PAINN", "graph", graph_pooling="mean"), tb
    if case == "zero_weights":
        return _cfg(spec, "PAINN", "graph", energy_weight=0.0,
                    energy_peratom_weight=0.0, force_weight=0.0), tb
    if case == "gaussian_nll":
        return _cfg(spec, "PAINN", "graph", loss_function_type="GaussianNLLLoss"), tb
    missing = case.split("_", 1)[1]
    return _cfg(spec, "PAINN", "graph"), dataclasses.replace(tb, **{missing: None})


@pytest.mark.parametrize("case,match", [
    ("two_heads", "exactly one head"),
    ("mean_pooled_graph_head", "sum pooling"),
    ("zero_weights", "loss weights are zero"),
    ("gaussian_nll", "GaussianNLLLoss is not supported"),
    ("no_pos", "must be provided"),
    ("no_energy", "must be provided"),
    ("no_forces", "must be provided"),
])
def test_mlip_errors(port, batches, case, match):
    """train/mlip.py refuses what the JAX package's refuses, with its
    messages."""
    _, tb = batches
    cfg, batch = _error_case(port, tb, case)
    model = port.create.create_model(cfg, "cpu")
    with pytest.raises(ValueError, match=match):
        port.mlip.energy_force_loss(model, batch, cfg)


@pytest.mark.parametrize("mpnn_type,head_type", CASES)
def test_port_forces_rotate_with_positions(port, mpnn_type, head_type):
    """A seeded rotation of the positions leaves the port's energies
    unchanged and rotates its forces (tests/test_forces_equivariant.py's
    check and tolerances), through K1/K2's plain versions."""
    rot = _rotation(seed=11)
    tcfg = _cfg(port.spec, mpnn_type, head_type, hidden_dim=8, radius=2.0)
    model = port.create.create_model(tcfg, "cpu", seed=3)
    out = []
    for rotation in (None, rot):
        s = _sample("random", seed=5, rotation=rotation)
        batch = port.graph.collate(_to_port(port, [s]), with_segment_plan=True)
        ge, forces = port.mlip.energy_and_forces(model, batch, tcfg, create_graph=False)
        out.append((ge.detach().numpy(), forces.numpy()))
    (e0, f0), (e1, f1) = out
    assert np.abs(f0).max() > 1e-4
    np.testing.assert_allclose(e0, e1, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f0 @ rot.T, f1, rtol=1e-3, atol=1e-4)


@pytest.mark.slow
def test_port_painn_mlip_training_reduces_loss(port):
    """30 AdamW steps of the port's PaiNN potential on 8 molecules cut the
    loss by a fifth (tests/test_interatomic_potential.py's check)."""
    cfg = _cfg(port.spec, "PAINN", "graph")
    model = port.create.create_model(cfg, "cpu", seed=0)
    samples = _to_port(port, mock_molecular_samples(n_graphs=8, seed=1))
    batch = port.graph.collate(samples, with_segment_plan=True)
    opt = port.optimizer.select_optimizer(model.parameters(), TRAINING)
    step = port.loop.make_train_step(model, opt, cfg, compute_grad_energy=True)
    state = port.loop.TrainState(model, opt)
    losses = []
    for _ in range(30):
        state, tot, _ = step(state, batch)
        losses.append(float(tot))
    assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]


def _md17_config():
    """examples/md17/md17.json's PaiNN potential cut to the small test
    widths, for two epochs at batch 8."""
    arch = {
        "mpnn_type": "PAINN", "radius": 2.5, "max_neighbours": 16, "num_radial": 6,
        "num_gaussians": 8, "num_filters": 16, "hidden_dim": 16, "num_conv_layers": 2,
        "graph_pooling": "add", "enable_interatomic_potential": True,
        "energy_weight": 1.0, "energy_peratom_weight": 0.0, "force_weight": 10.0,
        "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 16,
                                   "num_headlayers": 2, "dim_headlayers": [16, 16]}},
        "task_weights": [1.0],
    }
    return {
        "Verbosity": {"level": 0},
        "NeuralNetwork": {
            "Architecture": arch,
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["energy"],
                "output_index": [0], "type": ["graph"], "output_dim": [1],
            },
            "Training": {
                "batch_size": 8, "num_epoch": 2, "perc_train": 0.8,
                "Optimizer": {"type": "AdamW", "learning_rate": 0.002},
                "Parallelism": {"scheme": "single", "packing": {"enabled": False},
                                "superstep": {"steps": 1}, "pipeline": {"workers": 0}},
            },
        },
    }


@pytest.mark.slow
def test_mlip_run_training_matches_jax(port, monkeypatch, tmp_path):
    """Two epochs of run_training on a PaiNN potential from the same
    initial parameters: the per-epoch losses equal JAX's, and
    run_prediction returns finite energies and forces."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    splits = jsplit_dataset(mock_molecular_samples(n_graphs=40, seed=2), 0.8)
    captured = {}

    def spy(model, example, seed=0):
        out = jax.jit(lambda b: init_params(model, b, seed=seed))(example)
        captured["params"] = jax.device_get(out[0])
        return out

    monkeypatch.setattr(jrunner, "init_params", spy)
    _, _, _, j_hist, _ = hydragnn_tpu.run_training(
        copy.deepcopy(_md17_config()), datasets=splits
    )
    sd = port.convert.params_from_jax(captured["params"])
    make = port.runner.create_model_config

    def with_jax_params(config, device=None, *, seed=0):
        model, cfg = make(config, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    monkeypatch.setattr(port.runner, "create_model_config", with_jax_params)
    t_splits = tuple(_to_port(port, s) for s in splits)
    state, model, cfg, t_hist, full = port.runner.run_training(
        _md17_config(), datasets=t_splits, device="cpu"
    )
    for name in ("train_loss", "val_loss", "test_loss"):
        _assert_close(getattr(t_hist, name), getattr(j_hist, name), GRAD_TOL, name)
    err, tasks, trues, preds = port.runner.run_prediction(
        full, datasets=t_splits, state=state, model=model, cfg=cfg
    )
    assert tasks.shape == (3,) and len(preds) == 2
    assert preds[0].shape == trues[0].shape and preds[1].shape == trues[1].shape
    assert np.isfinite(preds[0]).all() and np.isfinite(preds[1]).all()
    np.testing.assert_allclose(err, t_hist.test_loss[-1], rtol=1e-6)
