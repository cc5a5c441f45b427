"""The port's last nine example drivers (hydragnn_tpu_torch/drivers/:
polymers, the multibranch and multi-dataset drivers and their searches,
the SC26 model-family search, the structure relaxation, UV spectra and
Ising) against the reference scripts of ``examples/``, on the CPU.

- What each driver hands its entry point (``run_training``, directly or
  through ``utils/hpo``'s ``random_search``/``run_trial``) equals what its
  reference script hands the JAX package's: every call's config, seed
  and splits, sample by sample and field by field, bit for bit. Both
  ``main()``s run with ``run_training`` replaced by a stub that records
  its arguments (in the JAX package at ``hydragnn_tpu.runner`` and at
  ``hydragnn_tpu.run_training``, which the JAX ``run_trial`` calls), so
  nothing trains; the radius graphs come through the native cell list
  and, with ``HYDRAGNN_TPU_NO_NATIVE=1``, the numpy path. sc26 is
  compared for worker 0 and worker 1 of two.
- multibranch: the branch sets and ``proportional_branch_split`` equal
  the reference's, its ``ModelConfig`` equals the reference's field by
  field, and one two-rank run on the CPU (``--nosync 2``) gives finite
  losses, the ranks' parameters equal, moving on every second step.
- The relaxation: from the JAX package's PaiNN parameters
  (``convert.params_from_jax``), one block of 5 descent steps at lr 2e-3
  through the port's ``relax`` against the reference's jitted
  ``lax.fori_loop`` of ``jax.grad``: positions at rtol 1e-4 / atol 1e-3,
  energies at rtol 1e-5 / atol 1e-4.
- multidataset end to end (8 samples a family): the first collated
  batch equals the JAX loader's field by field (``dataset_id`` and the
  zero-filled ``cell`` / ``edge_shifts`` included; the block plans cover
  the same edges), each branch's outputs match from the JAX parameters
  at the f32 forward tolerance, and one AdamW step's loss and every
  gradient (every decoder branch's included) at the gradient tolerance.
- Each driver's ``main([... tiny ..., "--device", "cpu"])`` returns finite
  numbers; with ``--device cuda`` and no card each refuses with the
  port's RuntimeError.
- chip_smoke.py's table of these drivers' data digests is this CPU
  build's, its launch model counts polymers.json's conv node head (3) and
  GIN (0), and the polymers driver's chains equal tests/_torch_polymers.py's.
"""

import contextlib
import copy
import dataclasses
import io
import math
import os
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
RELAX_POS_TOL = dict(rtol=1e-4, atol=1e-3)
RELAX_STEPS, RELAX_LR = 5, 2e-3

# case -> (reference script, its arguments, port module, the port's extra
# arguments); every case with --epochs 3 so that num_epoch is held too
CASES = {
    "polymers": ("open_polymers_2026/train.py", ["--chains", "20"], "polymers", []),
    "multibranch_hpo": ("multibranch_hpo/train.py", ["--sizes", "16", "8", "--trials", "2"],
                        "multibranch_hpo", ["--ranks", "1"]),
    "multidataset": ("multidataset/train.py", ["--per_family", "10"], "multidataset", []),
    "multidataset_hpo": ("multidataset_hpo/train.py", ["--per_family", "10", "--trials", "2"],
                         "multidataset_hpo", []),
    "sc26_worker0": ("multidataset_hpo_sc26/train_hpo.py",
                     ["--frames", "20", "--trials", "2", "--worker", "0", "--num-workers", "2"],
                     "sc26_hpo", []),
    "sc26_worker1": ("multidataset_hpo_sc26/train_hpo.py",
                     ["--frames", "20", "--trials", "2", "--worker", "1", "--num-workers", "2"],
                     "sc26_hpo", []),
    "uv_spectrum": ("dftb_uv_spectrum/uv_spectrum.py", ["--mols", "20"], "uv_spectrum", []),
    "ising": ("ising_model/ising.py", ["--configs", "20"], "ising", []),
}
# each driver's main() on the CPU at a tiny size (the multibranch drivers:
# test_multibranch_two_ranks_on_the_cpu and the handed-arguments case)
RUNS = {
    "polymers": ["--chains", "16"],
    "multidataset": ["--per_family", "8"],
    "multidataset_hpo": ["--per_family", "8", "--trials", "1"],
    "sc26_hpo": ["--frames", "20", "--trials", "3"],
    "structure_optimization": ["--frames", "20", "--blocks", "2", "--steps", "3"],
    "uv_spectrum": ["--mols", "20"],
    "ising": ["--configs", "20"],
}
MODULES = ["ising", "multibranch", "multibranch_hpo", "multidataset", "multidataset_hpo",
           "polymers", "sc26_hpo", "structure_optimization", "uv_spectrum"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    torch.set_num_threads(1)


def _reference(rel_path):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from common.loaders import load_example_module

    return load_example_module(rel_path, name="ref_" + rel_path.replace("/", "_")[:-3])


def _examples_common(name):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import importlib

    return importlib.import_module(f"common.{name}")


def _driver(name):
    import importlib

    return importlib.import_module(f"hydragnn_tpu_torch.drivers.{name}")


def _stub(calls):
    """A run_training recording each call's arguments."""
    def run_training(config, datasets=None, **kw):
        kw.pop("device", None)
        calls.append(dict(config=copy.deepcopy(config), datasets=datasets, kw=kw))
        hist = types.SimpleNamespace(train_loss=[0.0], val_loss=[0.0], test_loss=[0.0],
                                     test_tasks=[np.zeros(3)])
        return None, None, None, hist, None

    return run_training


def _handed(case):
    """(reference's, port's) recorded run_training calls for a case."""
    import hydragnn_tpu
    import hydragnn_tpu.runner as jrunner

    from hydragnn_tpu_torch import runner

    rel, argv, module, extra = CASES[case]
    argv = argv + ["--epochs", "3"]
    want, got = [], []
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(jrunner, "run_training", _stub(want))
        mp.setattr(hydragnn_tpu, "run_training", _stub(want))
        mp.setattr(runner, "run_training", _stub(got))
        mp.setattr(sys, "argv", [rel] + argv)
        _reference(rel).main()
        _driver(module).main(argv + extra + ["--device", "cpu"])
    return want, got


def _same_samples(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            x, y = getattr(g, f.name), getattr(w, f.name)
            assert (x is None) == (y is None), f.name
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert type(x) is type(y) and x == y, f.name


def _same_datasets(got, want):
    """The splits (or, under the multibranch scheme, each branch's
    splits) sample by sample."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (list, tuple)) and w and isinstance(w[0], (list, tuple)):
            _same_datasets(g, w)
        else:
            _same_samples(g, w)


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_hands_the_reference_arguments(case, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    want, got = _handed(case)
    assert len(got) == len(want) >= 1
    trials = case.startswith(("sc26", "multibranch_hpo", "multidataset_hpo"))
    assert (len(want) == 2) if trials else (len(want) == 1)
    for g, w in zip(got, want):
        assert g["config"] == w["config"]
        assert g["config"]["NeuralNetwork"]["Training"]["num_epoch"] == 3
        assert g["kw"] == w["kw"]
        _same_datasets(g["datasets"], w["datasets"])


# ------------------------------------------------------------ multibranch


@pytest.mark.parametrize("native", ["native", "numpy"])
def test_branch_sets_equal_reference(native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    ref = _reference("multibranch/train.py")
    port = _driver("multibranch")
    for n, scale, seed in ((24, 1.0, 0), (12, 2.0, 1), (9, 3.0, 2)):
        _same_samples(port.make_branch_dataset(n, scale, seed),
                      ref.make_branch_dataset(n, scale, seed))
    _same_samples([s for b in port.branch_sets((12, 9)) for s in b],
                  [s for bi, n in enumerate((12, 9))
                   for s in ref.make_branch_dataset(n, 1.0 + bi, seed=bi)])


def test_proportional_split_equals_reference():
    from hydragnn_tpu.parallel.multibranch import proportional_branch_split as jsplit

    from hydragnn_tpu_torch.parallel.multibranch import proportional_branch_split

    for sizes, ranks in (((300, 120, 80), 3), ((300, 120, 80), 8), ((120, 48, 32), 3),
                         ((160, 80), 2), ((24, 12), 2), ((24, 12), 5)):
        assert proportional_branch_split(sizes, ranks) == jsplit(sizes, ranks), (sizes, ranks)


def test_multibranch_model_config_equals_reference(monkeypatch):
    """The reference's ModelConfig, caught where its main() builds the
    model, against the driver's at the same --hidden_dim and branches."""
    import hydragnn_tpu.models.create as jcreate

    class Built(Exception):
        pass

    seen = {}

    def create_model(cfg):
        seen["cfg"] = cfg
        raise Built

    monkeypatch.setattr(jcreate, "create_model", create_model)
    monkeypatch.setattr(sys, "argv", ["train.py", "--sizes", "24", "12", "8", "--hidden_dim",
                                      "8"])
    with pytest.raises(Built), contextlib.redirect_stdout(io.StringIO()):
        _reference("multibranch/train.py").main()
    want = seen["cfg"]
    got = _driver("multibranch").model_config(8, 3)
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        assert dataclasses.asdict(got)[name] == dataclasses.asdict(want)[name], name


def test_multibranch_two_ranks_on_the_cpu(tmp_path, monkeypatch):
    """Two gloo ranks (processes of the driver) with --nosync 2: finite
    losses, the ranks' parameters equal after every step, and moving only
    on every second step."""
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        out = _driver("multibranch").main(["--ranks", "2", "--sizes", "24", "12",
                                           "--hidden_dim", "8", "--batch_size", "4",
                                           "--epochs", "1", "--nosync", "2", "--device", "cpu"])
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(math.isfinite(x) for r in ranks for x in r["epoch_loss"])
    assert ranks[0]["step_digests"] == ranks[1]["step_digests"]
    d = ranks[0]["step_digests"]
    assert len(d) == 4  # before the first step, then 3 steps (branch 1's 12 samples by 4)
    assert [a != b for a, b in zip(d, d[1:])] == [False, True, False]


# ------------------------------------------------------------ relaxation


def _assert_close(got, want, tol, name="", scale=None):
    """rtol, and atol times min(scale, 1), ``scale`` being the
    reference's largest magnitude (tests/test_torch_mlip.py's rule)."""
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    if not np.abs(want).any():
        assert not np.abs(got).any(), name
        return
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0),
                               err_msg=name)


def test_relax_block_matches_jax(monkeypatch):
    """One block of RELAX_STEPS descent steps from the reference's
    perturbed frame: the reference script's energy and jitted descent
    (``collate`` without a plan, ``model.apply``, ``jax.grad`` in a
    ``lax.fori_loop``) against the port's ``relax`` on the CPU from the
    same PaiNN parameters."""
    import jax
    import jax.numpy as jnp
    from hydragnn_tpu.config.config import update_config as jupdate_config
    from hydragnn_tpu.data.graph import PadSpec, collate
    from hydragnn_tpu.data.loader import split_dataset as jsplit
    from hydragnn_tpu.models.create import create_model_config as jcreate_model_config
    from hydragnn_tpu.models.create import init_params
    from hydragnn_tpu.ops.neighbors import radius_graph

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.drivers import common, structure_optimization
    from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames
    from hydragnn_tpu_torch.models import convert
    from hydragnn_tpu_torch.models.create import create_model_config

    config = _reference("multidataset_hpo_sc26/train_hpo.py").base_config(1, 8)
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = "PAINN"
    jframes = _examples_common("molecules").random_molecule_frames(20, seed=0)
    jfull = jupdate_config(copy.deepcopy(config), *jsplit(jframes, 0.8))
    model, jcfg = jcreate_model_config(jfull)
    sample = jframes[0]
    pos0 = sample.pos + np.random.default_rng(7).normal(
        scale=0.25, size=sample.pos.shape).astype(np.float32)
    moved = dataclasses.replace(sample, pos=pos0.astype(np.float32),
                                edge_index=radius_graph(pos0, 4.0, max_neighbours=24))
    batch = collate([moved], PadSpec.for_samples([moved]))
    n_real = sample.pos.shape[0]
    params = jax.jit(lambda b: init_params(model, b, seed=0)[0]).lower(batch).compile(
        {"xla_backend_optimization_level": 0})(batch)

    def energy(pos_real, p):
        b = dataclasses.replace(batch, pos=batch.pos.at[:n_real].set(pos_real))
        out = model.apply({"params": p, "batch_stats": {}}, b, train=False)
        return jnp.sum(jnp.where(batch.graph_mask, out[0][:, 0], 0.0))

    def run(p, pos):
        moved_pos = jax.lax.fori_loop(
            0, RELAX_STEPS, lambda _, q: q - RELAX_LR * jax.grad(energy)(q, p), pos)
        return energy(pos, p), moved_pos, energy(moved_pos, p)

    compiled = jax.jit(run).lower(params, pos0).compile({"xla_backend_optimization_level": 0})
    e0, j_pos, e1 = jax.device_get(compiled(params, pos0))

    frames = random_molecule_frames(20, seed=0)
    tfull = update_config(copy.deepcopy(config), *common.split(frames))
    tmodel, tcfg = create_model_config(tfull, "cpu", seed=0)
    tmodel.load_state_dict(convert.params_from_jax(jax.device_get(params)))
    res = structure_optimization.relax(tmodel, tcfg, frames[0], pos0, blocks=1,
                                       steps=RELAX_STEPS, lr=RELAX_LR, device="cpu")
    assert res["pos"].dtype == np.float32 and res["pos"].shape == j_pos.shape
    assert float(np.abs(res["pos"] - pos0).max()) > 0
    _assert_close(res["pos"], j_pos, RELAX_POS_TOL, "positions")
    assert len(res["energies"]) == 3 and res["energies"][1] == res["energies"][2]
    _assert_close(res["energies"][:2], [e0, e1], F32_TOL, "energies")
    assert res["energies"][1] < res["energies"][0]
    assert res["eager_steps"] == RELAX_STEPS and res["captures"] == 0


# ------------------------------------------------------ multidataset end to end


@pytest.fixture(scope="module")
def md_case():
    """multidataset's 8-a-family mix (26 samples: molecules, crystals and
    one reaction path of ten frames) as both drivers hand it over, the
    two packages' full configs and their first collated train batch (the
    whole train split, with the block plan)."""
    from hydragnn_tpu.config.config import update_config as jupdate_config
    from hydragnn_tpu.data.loader import GraphLoader as JLoader

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader

    CASES["md_parity"] = ("multidataset/train.py", ["--per_family", "8"], "multidataset", [])
    try:
        (want,), (got,) = _handed("md_parity")
    finally:
        del CASES["md_parity"]
    jsets, tsets = want["datasets"], got["datasets"]
    jfull = jupdate_config(copy.deepcopy(want["config"]), *jsets)
    tfull = update_config(copy.deepcopy(got["config"]), *tsets)
    n = len(jsets[0])
    jb = next(iter(JLoader(jsets[0], n, with_segment_plan=True)))
    tb = next(iter(GraphLoader(tsets[0], n, with_segment_plan=True)))
    return jfull, tfull, jb, tb


def test_multidataset_batch_equals_jax_loader(md_case):
    jfull, tfull, jb, tb = md_case
    assert tfull == jfull
    names = [f.name for f in dataclasses.fields(jb)]
    assert set(names) == {f.name for f in dataclasses.fields(tb)} - {"seg_tile"}
    plan = ("seg_perm", "seg_ids", "seg_valid", "seg_window")
    for name in names:
        j, t = getattr(jb, name), getattr(tb, name)
        assert (j is None) == (t is None), name
        if j is None or name in plan:
            continue
        t, j = np.asarray(t.numpy() if hasattr(t, "numpy") else t), np.asarray(j)
        assert j.shape == t.shape and j.dtype == t.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    for b in (jb, tb):
        perm, valid = (np.asarray(getattr(b, k)) for k in ("seg_perm", "seg_valid"))
        np.testing.assert_array_equal(np.sort(perm[valid]),
                                      np.flatnonzero(np.asarray(b.edge_mask)))
        assert (np.diff(np.asarray(b.receivers)[perm[valid]]) >= 0).all()
    # every family in the batch; the crystals periodic, the others with
    # the identity cell collate fills in and zero shifts
    gm = np.asarray(jb.graph_mask)
    ids = np.asarray(jb.dataset_id)[gm]
    assert set(ids.tolist()) == {0, 1, 2}
    periodic = ~(np.asarray(jb.cell) == np.eye(3, dtype=np.float32)).all(axis=(1, 2))
    assert (periodic[gm] == (ids == 1)).all()
    edge_graph = np.asarray(jb.node_graph_idx)[np.asarray(jb.receivers)]
    em = np.asarray(jb.edge_mask)
    gas_edges = em & (np.asarray(jb.dataset_id)[edge_graph] != 1)
    assert gas_edges.any() and not np.asarray(jb.edge_shifts)[gas_edges].any()
    assert np.asarray(jb.edge_shifts)[em & ~gas_edges].any()


@pytest.fixture(scope="module")
def md_reference(md_case):
    """The JAX package's initial SchNet parameters on the batch, its
    routed outputs and each branch's outputs (every graph sent to branch
    b), and one train step's loss, per-task losses and gradients (one
    compile at XLA's lowest backend optimisation)."""
    import jax
    import jax.numpy as jnp
    from hydragnn_tpu.models.create import create_model_config, init_params
    from hydragnn_tpu.train.losses import multihead_loss

    jfull, _, jb, _ = md_case
    model, cfg = create_model_config(jfull)
    params = jax.jit(lambda b: init_params(model, b, seed=0)[0]).lower(jb).compile(
        {"xla_backend_optimization_level": 0})(jb)
    n_branches = len(cfg.graph_branches)

    def run(p, batch):
        apply = lambda b: model.apply({"params": p, "batch_stats": {}}, b, train=False)  # noqa
        routed = apply(batch)[0]
        each = [apply(dataclasses.replace(batch, dataset_id=jnp.full_like(batch.dataset_id, bi)))
                [0] for bi in range(n_branches)]

        def loss(pp):
            out = model.apply({"params": pp, "batch_stats": {}}, batch, train=True)
            return multihead_loss(out, batch, cfg)

        (tot, tasks), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return routed, each, tot, tasks, grads

    compiled = jax.jit(run).lower(params, jb).compile({"xla_backend_optimization_level": 0})
    return jax.device_get(params), jax.device_get(compiled(params, jb))


def test_multidataset_branches_and_step_match_jax(md_case, md_reference):
    """From the JAX parameters: the routed outputs and each branch's at
    the f32 forward tolerance; one AdamW train step's loss, per-task
    losses and every parameter gradient (every decoder branch's) at the
    gradient tolerance."""
    import torch

    from hydragnn_tpu_torch.models import convert
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train import loop, optimizer

    _, tfull, _, tb = md_case
    params, (j_routed, j_each, j_tot, j_tasks, j_grads) = md_reference
    model, cfg = create_model_config(tfull, "cpu", seed=0)
    model.load_state_dict(convert.params_from_jax(params))
    gm = tb.graph_mask.numpy()
    model.eval()
    with torch.no_grad():
        _assert_close(model(tb)[0].numpy()[gm], np.asarray(j_routed)[gm], F32_TOL, "routed")
        for bi, want in enumerate(j_each):
            b = dataclasses.replace(tb, dataset_id=torch.full_like(tb.dataset_id, bi))
            _assert_close(model(b)[0].numpy()[gm], np.asarray(want)[gm], F32_TOL,
                          f"branch {bi}")
    training = tfull["NeuralNetwork"]["Training"]
    opt = optimizer.select_optimizer(model.parameters(), training)
    step = loop.make_train_step(model, opt, cfg)
    _, tot, tasks = step(loop.TrainState(model, opt), tb)
    _assert_close(tot.numpy(), j_tot, GRAD_TOL, "loss")
    _assert_close(tasks.numpy(), j_tasks, GRAD_TOL, "per-task losses")
    want_g = convert.params_from_jax(j_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    branches = {n.split(".")[1] for n in named if n.startswith("decoder")}
    assert {f"graph_shared_{b}" for b in ("molecules", "crystals", "reactions")} <= branches
    g_scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in named.items():
        assert p.grad is not None and (name.startswith("encoder") or p.grad.abs().max() > 0), name
        _assert_close(p.grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}",
                      scale=g_scale)


# ------------------------------------------------------------ each driver


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


@pytest.mark.parametrize("name", sorted(RUNS))
def test_driver_main_runs_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        out = _driver(name).main(RUNS[name] + ["--epochs", "1", "--device", "cpu"])
    assert out and _finite(out), out
    if name == "structure_optimization":
        assert out["e_last"] < out["e_first"] and len(out["energies"]) == 4
    elif name == "sc26_hpo":
        kinds = {p["NeuralNetwork.Architecture.mpnn_type"] for p, _ in out["trials"]}
        assert kinds == {"SchNet", "EGNN", "PAINN"}
    elif "hpo" not in name:
        assert {"train_loss", "test_loss"} <= set(out)


@pytest.mark.parametrize("name", MODULES)
def test_driver_refuses_cuda_without_a_card(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _driver(name).main(["--device", "cuda"])


# ------------------------------------------------------------ chip_smoke


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_gfm_digests_are_the_cpu_build():
    smoke = _chip_smoke()
    assert smoke.gfm_digests() == smoke.GFM_DIGESTS


def test_chip_smoke_launch_model_counts_the_conv_head_and_gin():
    """polymers.json's model: SAGE's means launch nothing, its conv node
    head ([64, 64] + 1) one a,W launch a layer: 3; uv_spectrum's GIN 0."""
    from hydragnn_tpu_torch.config import load_config, update_config
    from hydragnn_tpu_torch.drivers import common, polymers, uv_spectrum
    from hydragnn_tpu_torch.models.spec import model_config_from_dict

    smoke = _chip_smoke()
    config = load_config(common.example_path("open_polymers_2026", "polymers.json"))
    cfg = model_config_from_dict(update_config(
        config, *common.split(polymers.polymer_chains(10))))
    assert [b.node_head_type for b in cfg.node_branches] == ["conv"]
    assert smoke.launches_per_pass(cfg) == 3
    cfg = model_config_from_dict(update_config(
        uv_spectrum.spectrum_config(1), *common.split(uv_spectrum.synthetic_spectra(10))))
    assert cfg.mpnn_type == "GIN" and smoke.launches_per_pass(cfg) == 0


def test_polymer_chain_equals_the_tests_copy():
    sys.path.insert(0, HERE)
    import _torch_polymers

    from hydragnn_tpu_torch.drivers import polymers

    got = polymers.polymer_chains(12)
    rng = np.random.default_rng(26)
    _same_samples(got, [_torch_polymers.polymer_chain(rng) for _ in range(12)])
