"""The port's atomistic example drivers (hydragnn_tpu_torch/drivers/:
the Open Catalyst family, the crystal and the molecule drivers) against
the reference scripts of ``examples/``, on the CPU.

- What each driver hands ``run_training`` (qm7x_inference:
  ``run_prediction``) equals what its reference script hands the JAX
  package's: the config, the seed and the three splits, sample by
  sample and field by field, bit for bit. Both ``main()``s run with
  their entry point replaced by a stub that records its arguments, so
  nothing trains; the radius graphs come through the native cell list
  and, with ``HYDRAGNN_TPU_NO_NATIVE=1``, the numpy path.
- The shared generators (``drivers/crystals.py``, ``drivers/molecules.py``)
  equal examples/common's at every keyword set a driver uses.
- Each driver's ``main([... tiny ..., "--device", "cpu"])`` returns
  finite numbers (qm7x's training then its inference from the
  checkpoint it wrote); with ``--device cuda`` and no card each refuses
  with the port's RuntimeError.
- chip_smoke.py's table of the new generators' digests (and of
  alexandria's baseline coefficients) is this CPU build's, and its
  launch model knows every stack the drivers run and refuses one it does
  not know.
- oc25's mixed periodic and gas-phase set end to end: the first collated
  batch equals the JAX loader's field by field (``edge_shifts``
  zero-filled and ``cell`` the identity on the gas-phase graphs; the
  block plans, built at each package's own tile, cover the same edges),
  and from the JAX
  package's initial parameters (``convert.params_from_jax``) the
  energies and forces match at the f32 forward tolerance (rtol 1e-5,
  atol 1e-4) and one AdamW train step's loss and gradients at the
  gradient tolerance (rtol 1e-4, atol 1e-3), each atol scaled by the
  reference's largest magnitude where that is below 1, as
  tests/test_torch_mlip.py judges them; (``slow``) one epoch of
  ``run_training`` on it gives the JAX package's losses.
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

# driver case -> (reference script, its arguments, port module); every
# case with --epochs 3 so that the config's num_epoch is held too, and
# with 20 or more samples so that no split is empty
CASES = {
    "oc20": ("open_catalyst_2020/oc20.py", ["--systems", "20"], "oc20"),
    "oc20_schnet": ("open_catalyst_2020/oc20.py", ["--systems", "20", "--mpnn_type", "SchNet"],
                    "oc20"),
    "oc22": ("open_catalyst_2022/train.py", ["--systems", "20"], "oc22"),
    "odac23": ("open_direct_air_capture_2023/train.py", ["--systems", "20"], "odac23"),
    "oc25": ("open_catalyst_2025/train.py", ["--systems", "12"], "oc25"),
    "mptrj": ("mptrj/train.py", ["--structures", "20"], "mptrj"),
    "mptrj_forces": ("mptrj/train.py", ["--structures", "20", "--forces"], "mptrj"),
    "alexandria": ("alexandria/train.py", ["--structures", "20"], "alexandria"),
    "eam": ("eam/eam.py", ["--structures", "20"], "eam"),
    "eam_multitask": ("eam/eam.py", ["--structures", "20", "--multitask"], "eam"),
    "omat24": ("open_materials_2024/train.py", ["--structures", "20"], "omat24"),
    "ani1x": ("ani1_x/train.py", ["--frames", "24"], "ani1x"),
    "ani1x_mlip": ("ani1_x/train.py", ["--frames", "24", "--mlip"], "ani1x"),
    "nabla2_dft": ("nabla2_dft/train.py", ["--frames", "20"], "nabla2_dft"),
    "omol25": ("open_molecules_2025/train.py", ["--frames", "24"], "omol25"),
    "qcml": ("qcml/train.py", ["--frames", "30"], "qcml"),
    "transition1x": ("transition1x/train.py", ["--reactions", "4", "--frames_per_path", "5"],
                     "transition1x"),
    "qm7x": ("qm7x/train.py", ["--frames", "20"], "qm7x"),
    "qm7x_mlip": ("qm7x/train.py", ["--frames", "20", "--mlip"], "qm7x"),
    "qm7x_inference": ("qm7x/inference.py", ["--frames", "20"], "qm7x_inference"),
    "qm7x_inference_mlip": ("qm7x/inference.py", ["--frames", "20", "--mlip"],
                            "qm7x_inference"),
}
# each driver's main() on the CPU at a tiny size
RUNS = {
    "oc20": ["--systems", "16"],
    "oc22": ["--systems", "16"],
    "odac23": ["--systems", "16"],
    "oc25": ["--systems", "16"],
    "mptrj": ["--structures", "16"],
    "mptrj_forces": ["--structures", "16", "--forces"],
    "alexandria": ["--structures", "16"],
    "eam": ["--structures", "16"],
    "eam_multitask": ["--structures", "16", "--multitask"],
    "omat24": ["--structures", "16"],
    "ani1x": ["--frames", "16"],
    "ani1x_mlip": ["--frames", "16", "--mlip"],
    "nabla2_dft": ["--frames", "16"],
    "omol25": ["--frames", "16"],
    "qcml": ["--frames", "16"],
    "transition1x": ["--reactions", "2", "--frames_per_path", "8"],
}
MODULES = sorted({c[2] for c in CASES.values()})

# examples/common generators at the keyword sets the drivers use
CRYSTAL_KW = {
    "mptrj": dict(species=(28, 41, 13, 22), seed=3),
    "alexandria": dict(species=(28, 41, 13, 22), seed=11),
    "eam": dict(species=(28, 41), seed=5),
    "eam_multitask": dict(species=(28, 41), node_energies=True, seed=5),
    "omat24": dict(species=(28, 41, 13, 22), jitter=0.06, vacancy_rate=0.10, seed=24),
    "per_atom_unnormalized": dict(per_atom_energy=True, node_energies=True, normalize=False),
}
MOLECULE_KW = {
    "oc25_gas": dict(seed=26),
    "ani1x": dict(species=(1, 6, 7, 8), n_molecules=16, feature="onehot"),
    "nabla2_dft": dict(species=(1, 6, 7, 8, 16), n_atoms_range=(12, 24), n_molecules=8,
                       jitter=0.14, seed=17, feature="onehot"),
    "omol25": dict(species=(1, 6, 7, 8, 16), n_atoms_range=(18, 32), n_molecules=20,
                   cutoff=4.5, max_neighbours=28, seed=25, feature="onehot"),
    "qcml": dict(species=(1, 6, 7, 8, 16), n_atoms_range=(4, 10), n_molecules=24, seed=41),
    "qm7x": dict(species=(1, 6, 7, 8, 16), n_atoms_range=(4, 12), n_molecules=14, seed=7,
                 feature="onehot"),
}


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


def _stub_result(entry):
    if entry == "run_prediction":
        return 0.0, np.zeros(1), [np.zeros((1, 1))], [np.zeros((1, 1))]
    hist = types.SimpleNamespace(train_loss=[0.0], val_loss=[0.0], test_loss=[0.0],
                                 test_tasks=[np.zeros(3)])
    return None, None, None, hist, None


@contextlib.contextmanager
def _recorded(runner, entry, seen):
    """``runner.<entry>`` replaced by a stub recording its arguments."""
    def stub(config, datasets=None, **kw):
        kw.pop("device", None)
        seen.update(config=copy.deepcopy(config), datasets=datasets, kw=kw)
        return _stub_result(entry)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, entry, stub)
        yield


def _handed(case):
    """(reference's, port's) {config, datasets, kw} for a driver case."""
    import hydragnn_tpu.runner as jrunner
    from hydragnn_tpu_torch import runner

    rel, argv, module = CASES[case]
    argv = argv + ["--epochs", "3"]
    entry = "run_prediction" if module == "qm7x_inference" else "run_training"
    want, got = {}, {}
    with _recorded(jrunner, entry, want), pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(io.StringIO()):
        mp.setattr(sys, "argv", [rel] + argv)
        _reference(rel).main()
    with _recorded(runner, entry, got), contextlib.redirect_stdout(io.StringIO()):
        _driver(module).main(argv + ["--device", "cpu"])
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


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_hands_the_reference_arguments(case, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    want, got = _handed(case)
    assert got["config"] == want["config"]
    assert got["config"]["NeuralNetwork"]["Training"]["num_epoch"] == 3
    assert got["kw"] == want["kw"]
    assert len(got["datasets"]) == len(want["datasets"]) == 3
    for g, w in zip(got["datasets"], want["datasets"]):
        _same_samples(g, w)


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("which", sorted(CRYSTAL_KW))
def test_crystals_equal_reference(which, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    kw = CRYSTAL_KW[which]
    got = _driver("crystals").random_crystals(6, **kw)
    want = _examples_common("crystals").random_crystals(6, **kw)
    _same_samples(got, want)


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("which", sorted(MOLECULE_KW) + ["reaction_paths"])
def test_molecules_equal_reference(which, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    port, ref = _driver("molecules"), _examples_common("molecules")
    if which == "reaction_paths":
        got, want = port.reaction_path_frames(3, 4), ref.reaction_path_frames(3, 4)
    else:
        kw = MOLECULE_KW[which]
        got = port.random_molecule_frames(20, **kw)
        want = ref.random_molecule_frames(20, **kw)
    _same_samples(got, want)


def test_energy_normalization_equals_reference():
    """common.energy_mean_std / normalized_energy_targets against
    examples/common/loaders.py's, on the oc22 slabs."""
    ref = _examples_common("loaders")
    common = _driver("common")
    slabs = _driver("oc20").synthetic_oc20(8, seed=22)
    assert common.energy_mean_std(slabs) == ref.energy_mean_std(slabs)
    _same_samples(common.normalized_energy_targets(slabs), ref.normalized_energy_targets(slabs))


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
    module = name.replace("_forces", "").replace("_multitask", "").replace("_mlip", "")
    with contextlib.redirect_stdout(io.StringIO()):
        out = _driver(module).main(RUNS[name] + ["--epochs", "1", "--device", "cpu"])
    assert out and _finite(out), out
    assert {"train_loss", "val_loss", "test_loss"} <= set(out)
    potentials = ("oc20", "oc25", "ani1x_mlip")
    assert ("test_force_loss" in out) == (name in potentials), out
    if name == "eam_multitask":
        assert {"test_energy_loss", "test_atomic_energy_loss"} <= set(out)


@pytest.mark.parametrize("mlip", [False, True])
def test_qm7x_train_then_inference(mlip, tmp_path, monkeypatch):
    """qm7x's run saves its checkpoint under logs/; qm7x_inference at the
    same --epochs restores it and predicts the same frames' test split
    with the error the training run reported for it."""
    monkeypatch.chdir(tmp_path)
    flags = ["--mlip"] if mlip else []
    args = ["--frames", "16", "--epochs", "1", "--device", "cpu"] + flags
    with contextlib.redirect_stdout(io.StringIO()):
        trained = _driver("qm7x").main(args)
        out = _driver("qm7x_inference").main(args)
    assert _finite(trained) and _finite(out), (trained, out)
    assert len(out["heads"]) == (3 if mlip else 1)
    assert out["samples"] == 3
    np.testing.assert_allclose(out["error"], trained["test_loss"], rtol=1e-6)


@pytest.mark.parametrize("name", MODULES)
def test_driver_refuses_cuda_without_a_card(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _driver(name).main(["--device", "cuda"])


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_atomistic_digests_are_the_cpu_build():
    """chip_smoke.py's [drivers] table of the atomistic generators'
    sha256, and of alexandria's fitted baseline, is what the port's
    generators build on the CPU."""
    smoke = _chip_smoke()
    assert smoke.atomistic_digests() == smoke.ATOMISTIC_DIGESTS
    assert smoke.alexandria_baseline()[1] == smoke.ALEXANDRIA_BASELINE


def test_chip_smoke_launch_model_knows_the_drivers_stacks():
    """K1 launches a forward for each stack the drivers run (MACE one a
    layer, SAGE/EGNN/DimeNet/GIN none); a stack no package has raises."""
    smoke = _chip_smoke()
    cfg = types.SimpleNamespace
    want = {"SchNet": 3, "PNA": 3, "PNAPlus": 3, "PAINN": 6, "GAT": 0, "MACE": 3,
            "SAGE": 0, "EGNN": 0, "DimeNet": 0, "GIN": 0}
    for stack, n in want.items():
        assert smoke.launches_per_pass(cfg(mpnn_type=stack, num_conv_layers=3)) == n, stack
    with pytest.raises(KeyError):
        smoke.launches_per_pass(cfg(mpnn_type="NoSuchStack", num_conv_layers=3))


# ------------------------------------------------------- oc25 end to end


def _assert_close(got, want, tol, name="", scale=None):
    """tests/test_torch_mlip.py's rule: rtol, and atol times min(scale,
    1), ``scale`` being the reference's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    if not np.abs(want).any():
        assert not np.abs(got).any(), name
        return
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0),
                               err_msg=name)


@pytest.fixture(scope="module")
def oc25_case():
    """oc25's 16-system mixed set as both drivers hand it over, the two
    packages' full configs and their first collated train batch: the
    whole train split (12 systems, periodic and gas-phase) in order, with
    the block plan."""
    from hydragnn_tpu.config.config import update_config as jupdate_config
    from hydragnn_tpu.data.loader import GraphLoader as JLoader

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.data.loader import GraphLoader

    CASES["oc25_parity"] = ("open_catalyst_2025/train.py", ["--systems", "16"], "oc25")
    try:
        want, got = _handed("oc25_parity")
    finally:
        del CASES["oc25_parity"]
    jsets, tsets = want["datasets"], got["datasets"]
    jfull = jupdate_config(copy.deepcopy(want["config"]), *jsets)
    tfull = update_config(copy.deepcopy(got["config"]), *tsets)
    n = len(jsets[0])
    jb = next(iter(JLoader(jsets[0], n, with_segment_plan=True)))
    tb = next(iter(GraphLoader(tsets[0], n, with_segment_plan=True)))
    return jfull, tfull, jb, tb


def test_oc25_mixed_batch_equals_jax_loader(oc25_case):
    jfull, tfull, jb, tb = oc25_case
    assert tfull == jfull
    names = [f.name for f in dataclasses.fields(jb)]
    # the port's batch also names its plan's tile (seg_tile)
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
    # the block plans are built at each package's own tile; both cover
    # every valid edge once, in receiver order
    for b in (jb, tb):
        perm, valid = (np.asarray(getattr(b, k)) for k in ("seg_perm", "seg_valid"))
        covered = np.sort(perm[valid])
        np.testing.assert_array_equal(covered, np.flatnonzero(np.asarray(b.edge_mask)))
        rcv = np.asarray(b.receivers)[perm[valid]]
        assert (np.diff(rcv) >= 0).all()
    # periodic and gas-phase graphs in the one batch: a gas-phase graph's
    # cell is the identity collate fills in, its edges' shifts zeros
    gm = np.asarray(jb.graph_mask)
    gas = (np.asarray(jb.cell) == np.eye(3, dtype=np.float32)).all(axis=(1, 2)) & gm
    assert gas.any() and (gm & ~gas).any(), gas
    edge_graph = np.asarray(jb.node_graph_idx)[np.asarray(jb.receivers)]
    on_gas = gas[edge_graph] & np.asarray(jb.edge_mask)
    assert on_gas.any() and not np.asarray(jb.edge_shifts)[on_gas].any()
    assert np.asarray(jb.edge_shifts)[~on_gas & np.asarray(jb.edge_mask)].any()


@pytest.fixture(scope="module")
def oc25_reference(oc25_case):
    """The JAX package's initial PaiNN parameters on oc25's batch (one
    compile at XLA's lowest backend optimisation), then one AdamW step's
    graph energies, forces, loss, per-task losses and gradients (one
    more), written as tests/test_torch_mlip.py writes them."""
    import jax

    from hydragnn_tpu.models.create import create_model_config, init_params
    from hydragnn_tpu.train.mlip import energy_and_forces, energy_force_loss_terms

    jfull, _, jb, _ = oc25_case
    model, cfg = create_model_config(jfull)
    init = jax.jit(lambda batch: init_params(model, batch, seed=0)[0])
    params = init.lower(jb).compile({"xla_backend_optimization_level": 0})(jb)

    def one(params, batch):
        def loss(p):
            ge, forces, _ = energy_and_forces(model, {"params": p, "batch_stats": {}}, batch,
                                              cfg, train=True)
            tot, tasks = energy_force_loss_terms(ge, forces, batch, cfg)
            return tot, (tasks, ge, forces)

        (tot, (tasks, ge, forces)), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return ge, forces, tot, tasks, grads

    run = jax.jit(one).lower(params, jb).compile({"xla_backend_optimization_level": 0})
    return jax.device_get(params), jax.device_get(run(params, jb))


def test_oc25_energies_forces_and_step_match_jax(oc25_case, oc25_reference):
    """From the JAX parameters: the port's graph energies and forces at
    the f32 forward tolerance, one train step's loss, per-task losses
    and every parameter gradient at the gradient tolerance."""
    import torch

    from hydragnn_tpu_torch.models import convert
    from hydragnn_tpu_torch.models.create import create_model_config
    from hydragnn_tpu_torch.train import loop, mlip, optimizer

    _, tfull, _, tb = oc25_case
    params, (j_ge, j_forces, j_tot, j_tasks, j_grads) = oc25_reference
    model, cfg = create_model_config(tfull, "cpu", seed=0)
    model.load_state_dict(convert.params_from_jax(params))
    ge, forces = mlip.energy_and_forces(model, tb, cfg, create_graph=False)
    gm, nm = tb.graph_mask.numpy(), tb.node_mask.numpy()
    _assert_close(ge.detach().numpy()[gm], np.asarray(j_ge)[gm], F32_TOL, "graph energies")
    _assert_close(forces.numpy()[nm], np.asarray(j_forces)[nm], F32_TOL, "forces")

    training = tfull["NeuralNetwork"]["Training"]
    opt = optimizer.select_optimizer(model.parameters(), training)
    step = loop.make_train_step(model, opt, cfg, compute_grad_energy=True)
    _, tot, tasks = step(loop.TrainState(model, opt), tb)
    _assert_close(tot.numpy(), j_tot, GRAD_TOL, "loss")
    _assert_close(tasks.numpy(), j_tasks, GRAD_TOL, "per-task losses")
    want_g = convert.params_from_jax(j_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    g_scale = max(float(g.abs().max()) for g in want_g.values())
    for name, p in named.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        _assert_close(grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}",
                      scale=g_scale)


@pytest.mark.slow
def test_oc25_run_training_matches_jax(oc25_case, tmp_path, monkeypatch):
    """One epoch of run_training on oc25's mixed set (one device, no
    packing), both packages from the JAX package's initial parameters:
    the train, val and test losses at the gradient tolerance."""
    import jax

    import hydragnn_tpu
    from hydragnn_tpu import runner as jrunner
    from hydragnn_tpu.models.create import init_params

    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.models import convert

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    want = {}
    with _recorded(jrunner, "run_training", want), contextlib.redirect_stdout(io.StringIO()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["train.py", "--systems", "16", "--epochs", "1"])
        _reference("open_catalyst_2025/train.py").main()
    config = copy.deepcopy(want["config"])
    config["Verbosity"] = {"level": 0}
    # one device and one feed for both (the JAX package would spread the
    # epoch over this host's eight virtual devices)
    config["NeuralNetwork"]["Training"]["Parallelism"] = {
        "scheme": "single", "packing": {"enabled": False}, "superstep": {"steps": 1},
        "pipeline": {"workers": 0}}
    captured = {}

    def spy(model, example, seed=0):
        out = jax.jit(lambda b: init_params(model, b, seed=seed))(example)
        captured["params"] = jax.device_get(out[0])
        return out

    monkeypatch.setattr(jrunner, "init_params", spy)
    *_, j_hist, _ = hydragnn_tpu.run_training(copy.deepcopy(config),
                                              datasets=want["datasets"], seed=0)
    sd = convert.params_from_jax(captured["params"])
    make = runner.create_model_config

    def with_jax_params(full, device=None, *, seed=0):
        model, cfg = make(full, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    monkeypatch.setattr(runner, "create_model_config", with_jax_params)
    got = {}
    with _recorded(runner, "run_training", got), contextlib.redirect_stdout(io.StringIO()):
        _driver("oc25").main(["--systems", "16", "--epochs", "1", "--device", "cpu"])
    *_, t_hist, _ = runner.run_training(copy.deepcopy(config), datasets=got["datasets"],
                                        seed=0, device="cpu")
    for name in ("train_loss", "val_loss", "test_loss"):
        _assert_close(getattr(t_hist, name), getattr(j_hist, name), GRAD_TOL, name)
