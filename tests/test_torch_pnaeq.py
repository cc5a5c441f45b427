"""PNAEq (PaiNN's layout with PNA's aggregators) against the JAX package.

Small models as in tests/test_torch_mlip.py (2 layers, hidden 16,
num_radial 6, a graph energy head with sum pooling; the degree histogram
from ``gather_deg`` of the data) on tests/test_interatomic_potential.py's
``mock_molecular_samples`` (six molecules of 6-10 atoms with energies and
forces), collated by both packages from the same numpy arrays into one
padded batch with spare nodes, edges and a spare graph slot, the block
plan attached. The JAX side runs as its own tests run it on the CPU, the
port through K1/K2's plain versions (K1's and K2's
operators): both of PNAEq's receiver sums (the moment pass of
width 2F, the vector message of width 3F) take the plan. Parameters are
drawn in numpy on ``jax.eval_shape``'s tree (no initializer compiles) and
carried over with ``params_from_jax``; one compiled JAX call gives every
reference.

- the forward (graph energies) against flax;
- ``energy_and_forces``: energies and forces (-dE/dpos, PNA's min/max
  and std differentiated once);
- one ``make_train_step(compute_grad_energy=True)`` AdamW step: the
  loss, the three per-task losses, every gradient (the double backward
  through segment_min's ties and std's clamp) and every updated
  parameter;
- rotating the positions rotates the forces;
- md17.json with ``mpnn_type: "PNAEq"`` (small) through run_training
  (packing "auto", which packs) and run_prediction on the CPU;
- (``slow``) the port's PNAEq to tests/test_graphs.py's 0.60 / 0.60 on
  the BCC set.

Tolerances as tests/test_torch_mlip.py states them: f32 forward rtol 1e-5
/ atol 1e-4, gradients (forces are one) rtol 1e-4 / atol 1e-3, each atol
times min(max|ref|, 1); one step's parameter gradients are scaled by the
largest over all parameters.
"""

import copy
import json
import os
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax

from hydragnn_tpu.config.config import gather_deg
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data.loader import split_dataset as jsplit_dataset
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.train.mlip import energy_and_forces as jenergy_and_forces
from hydragnn_tpu.train.mlip import energy_force_loss_terms
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import create_train_state

from tests.test_forces_equivariant import _rotation, _sample
from tests.test_interatomic_potential import mock_molecular_samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
TRAINING = {"Optimizer": {"type": "AdamW", "learning_rate": 3e-3}}


def _assert_close(got, want, tol, name="", scale=None):
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    if not np.abs(want).any():
        assert not np.abs(got).any(), name
        return
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * min(scale, 1.0), err_msg=name)


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data import graph
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.ops import edge_pipeline
    from hydragnn_tpu_torch.train import loop, mlip, optimizer

    return types.SimpleNamespace(torch=torch, runner=runner, graph=graph, convert=convert,
                                 create=create, spec=spec, ep=edge_pipeline, loop=loop,
                                 mlip=mlip, optimizer=optimizer)


def _to_port(port, samples):
    return [port.graph.GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index,
                                   energy=s.energy, forces=s.forces) for s in samples]


SAMPLES = mock_molecular_samples(n_graphs=6, seed=0)
PNA_DEG = tuple(int(v) for v in gather_deg(SAMPLES))


def _cfg(spec, **kw):
    """md17.json's PNAEq potential (graph head, add pooling, force weight
    10) at test widths."""
    return spec.ModelConfig(**{
        **dict(
            mpnn_type="PNAEq", input_dim=1, hidden_dim=16, num_conv_layers=2,
            heads=(spec.HeadSpec("energy", "graph", 1),),
            graph_branches=(spec.BranchSpec(num_sharedlayers=1, dim_sharedlayers=16,
                                            num_headlayers=2, dim_headlayers=(16, 16)),),
            node_branches=(spec.BranchSpec(),), task_weights=(1.0,), radius=2.5,
            num_radial=6, max_neighbours=len(PNA_DEG) - 1, pna_deg=PNA_DEG,
            graph_pooling="add", enable_interatomic_potential=True, energy_weight=1.0,
            energy_peratom_weight=0.5, force_weight=10.0,
        ),
        **kw,
    })


@pytest.fixture(scope="module")
def batches(port):
    """The six molecules padded with 8 spare nodes, 24 spare edges and a
    spare graph slot, with the block plan, as JAX and port batches."""
    pad = jgraph.PadSpec.for_samples(SAMPLES)
    pad = jgraph.PadSpec(pad.num_nodes + 8, pad.num_edges + 24, pad.num_graphs + 1)
    jb = jgraph.collate(SAMPLES, pad, with_segment_plan=True)
    tb = port.graph.collate(_to_port(port, SAMPLES),
                            port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs),
                            with_segment_plan=True)
    assert tb.seg_window is not None
    np.testing.assert_array_equal(np.asarray(jb.receivers), tb.receivers.numpy())
    return jb, tb


def _fill(tree, rng):
    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def reference(batches):
    """One compiled call: the head's forward output, then one MLIP step
    as tests/test_torch_mlip.py writes it (graph energies, forces, loss,
    per-task losses, gradients, AdamW-updated parameters)."""
    jb, _ = batches
    cfg = _cfg(jspec)
    model = jcreate_model(cfg)
    tx = jselect_optimizer(TRAINING)
    shapes = jax.eval_shape(lambda b: init_params(model, b, seed=0)[0], jb)
    params = _fill(shapes, np.random.default_rng(3))

    def run(params, batch):
        out = model.apply({"params": params, "batch_stats": {}}, batch)[0]

        def loss(p):
            ge, forces, _ = jenergy_and_forces(model, {"params": p, "batch_stats": {}},
                                               batch, cfg, train=True)
            tot, tasks = energy_force_loss_terms(ge, forces, batch, cfg)
            return tot, (tasks, ge, forces)

        (tot, (tasks, ge, forces)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        new = create_train_state(params, tx).apply_gradients(grads, tx)
        return out, ge, forces, tot, tasks, grads, new.params

    run = jax.jit(run).lower(params, jb).compile({"xla_backend_optimization_level": 0})
    return jax.device_get(run(params, jb)), params


def _port_model(port, params):
    model = port.create.create_model(_cfg(port.spec), "cpu")
    model.load_state_dict(port.convert.params_from_jax(params))
    return model


def test_pnaeq_forward_matches_flax(port, batches, reference):
    """The energy head's output on the planned batch equals flax's on the
    real graphs; params_from_jax maps PNAEq's whole tree."""
    _, tb = batches
    (out, *_), params = reference
    model = _port_model(port, params)
    names = {k.split(".")[-2] for k in model.state_dict() if ".message_0." in k}
    assert names == {"rbf_emb", "pre_nn", "scalar_mlp_0", "scalar_mlp_1", "scalar_mlp_2",
                     "rbf_lin", "post_nn"}
    with port.torch.no_grad():
        got = model(tb)[0][:, 0]
    gm = tb.graph_mask.numpy()
    _assert_close(got.numpy()[gm], np.asarray(out)[gm, 0], F32_TOL, "PNAEq graph head")


def test_pnaeq_energy_and_forces_match_jax(port, batches, reference):
    """Graph energies and forces equal JAX's; zero forces on padding
    atoms; the CPU path launches no kernel."""
    _, tb = batches
    (_, ge_ref, f_ref, *_), params = reference
    model = _port_model(port, params)
    launches = (port.ep.edge_pipeline_planned.launches,
                port.ep.edge_pipeline_bwd_planned.launches)
    ge, forces = port.mlip.energy_and_forces(model, tb, model.cfg)
    assert launches == (port.ep.edge_pipeline_planned.launches,
                        port.ep.edge_pipeline_bwd_planned.launches)
    assert forces.requires_grad
    _assert_close(ge.detach().numpy(), ge_ref, F32_TOL, "graph energies")
    _assert_close(forces.detach().numpy(), f_ref, GRAD_TOL, "forces")
    assert not forces.detach().numpy()[~tb.node_mask.numpy()].any()


def test_pnaeq_mlip_train_step_matches_jax(port, batches, reference):
    """One AdamW step on the energy + force loss: loss, per-task losses,
    every gradient (a second derivative through PNA's aggregators) and
    every updated parameter."""
    _, tb = batches
    (_, _, _, j_tot, j_tasks, j_grads, j_new), params = reference
    model = _port_model(port, params)
    opt = port.optimizer.select_optimizer(model.parameters(), TRAINING)
    step = port.loop.make_train_step(model, opt, model.cfg, compute_grad_energy=True)
    _, tot, tasks = step(port.loop.TrainState(model, opt), tb)
    _assert_close(tot.numpy(), j_tot, F32_TOL, "loss")
    _assert_close(tasks.numpy(), j_tasks, F32_TOL, "per-task losses")
    want_g = port.convert.params_from_jax(j_grads)
    want_p = port.convert.params_from_jax(j_new)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    g_scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in named.items():
        grad = p.grad if p.grad is not None else port.torch.zeros_like(p)
        assert np.isfinite(grad.numpy()).all(), name
        _assert_close(grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}",
                      scale=g_scale)
        _assert_close(p.detach().numpy(), want_p[name].numpy(), GRAD_TOL, f"param {name}")


def test_pnaeq_forces_rotate_with_positions(port):
    """A seeded rotation leaves the port's PNAEq energies unchanged and
    rotates its forces (tests/test_forces_equivariant.py's tolerances)."""
    rot = _rotation(seed=11)
    tcfg = _cfg(port.spec, hidden_dim=8, radius=2.0)
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


def _md17_pnaeq_config():
    """examples/md17/md17.json with ``mpnn_type: "PNAEq"`` (what
    examples/md17/md17.py --mpnn_type PNAEq runs) at test widths: hidden
    16, 2 layers, num_radial 6, radius 2.5, one epoch at batch 8."""
    with open(os.path.join(ROOT, "examples", "md17", "md17.json")) as f:
        config = json.load(f)
    config.pop("Simulation")
    config["Verbosity"] = {"level": 0}
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(mpnn_type="PNAEq", hidden_dim=16, num_conv_layers=2, num_radial=6,
                radius=2.5)
    arch["output_heads"]["graph"].update(dim_sharedlayers=16, dim_headlayers=[16, 16])
    config["NeuralNetwork"]["Training"].update(num_epoch=1, batch_size=8)
    return config


def test_md17_pnaeq_run_training_and_prediction(port, monkeypatch, tmp_path):
    """run_training (packing "auto" packs these molecules, as it does
    md17.json's) then run_prediction on the CPU: finite losses, energies
    [graphs, 1] and forces [atoms, 3]."""
    monkeypatch.chdir(tmp_path)
    splits = tuple(_to_port(port, s)
                   for s in jsplit_dataset(mock_molecular_samples(n_graphs=64, seed=2), 0.8))
    config = _md17_pnaeq_config()
    pk = port.runner.packing_settings(config)
    assert pk["enabled"] == "auto" and port.runner.resolve_packing(pk, 8, splits[0])[0]
    state, model, cfg, hist, full = port.runner.run_training(
        config, datasets=splits, device="cpu")
    assert cfg.mpnn_type == "PNAEq" and cfg.pna_deg is not None
    err, tasks, trues, preds = port.runner.run_prediction(
        full, datasets=splits, state=state, model=model, cfg=cfg)
    assert np.isfinite(hist.train_loss + hist.val_loss + [err]).all()
    assert tasks.shape == (3,) and len(preds) == 2
    n_atoms = sum(s.num_nodes for s in splits[2])
    assert preds[0].shape == (len(splits[2]), 1) and preds[1].shape == (n_atoms, 3)
    assert np.isfinite(preds[0]).all() and np.isfinite(preds[1]).all()


@pytest.mark.slow
def test_pnaeq_trains_to_threshold(port, tmp_path, monkeypatch):
    """The port's PNAEq on tests/test_graphs.py's BCC set (300
    configurations, seed 7, ci.json) reaches 0.60 / 0.60 (head RMSE,
    sample MAE), trained by run_training and predicted by
    run_prediction(config) alone from the run's checkpoint."""
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "dataset" / "unit_test")
    deterministic_graph_data(path, number_configurations=300, seed=7)
    with open(os.path.join(ROOT, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"]["path"] = {"total": path}
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = "PNAEq"
    config["NeuralNetwork"]["Training"]["Parallelism"] = {"scheme": "single"}
    port.runner.run_training(copy.deepcopy(config), device="cpu")
    _, _, trues, preds = port.runner.run_prediction(config, device="cpu")
    for t, p in zip(trues, preds):
        assert float(np.sqrt(np.mean((t - p) ** 2))) < 0.60
        assert float(np.mean(np.abs(t - p))) < 0.60
