"""The port's example drivers (hydragnn_tpu_torch/drivers/) and the
end-of-run plot hook of its ``run_training``, on the CPU.

- Each driver's data equals the reference script's from the same seed,
  bit for bit, the reference scripts loaded by path as
  examples/common/loaders.load_example_module loads them: Lennard-Jones
  configurations (periodic graphs and shifts), the MD17 stand-in, the
  generated QM9 and ZINC molecules (Laplacian and relative PE), the
  csce and ogb SMILES samples (``random_smiles`` -> target ->
  ``graph_sample_from_smiles``) and the LSMS files of
  ``deterministic_graph_data``; the radius graphs through the native cell
  list and, with ``HYDRAGNN_TPU_NO_NATIVE=1``, the numpy path, edge order
  included. qm9_hpo's base config and search space equal the ones the
  reference script hands ``random_search``; chip_smoke.py's table of the
  generators' digests is this CPU build's.
- Each driver's ``main([..., "--device", "cpu"])`` runs end to end at a
  tiny size (tests/test_examples.py's sizes or smaller; LennardJones and
  md17 with ``--simulate --sim_steps 8``, qm9_hpo with ``--trials 2``,
  zinc also in bf16) and returns finite numbers; with ``--device cuda``
  and no card each refuses with the port's RuntimeError, and qm9 refuses
  the real-QM9 path.
- The plot hook: qm9.json with ``Visualization.create_plots`` through
  the port's and the JAX package's ``run_training`` leaves the same plot
  files under ``logs/<name>/``, the hook's per-sample trues equal the
  test split's targets (and the JAX hook's trues); with matplotlib
  unimportable the port's hook raises ImportError.
"""

import contextlib
import dataclasses
import filecmp
import json
import math
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

DRIVERS = {
    "lennard_jones": ["--configs", "24", "--epochs", "1", "--simulate", "--sim_steps", "8"],
    "md17": ["--frames", "40", "--epochs", "1", "--simulate", "--sim_steps", "8"],
    "qm9": ["--synthetic", "--mols", "40", "--epochs", "1"],
    "zinc": ["--mols", "40", "--epochs", "1"],
    "zinc_bf16": ["--mols", "40", "--epochs", "1", "--precision", "bf16"],
    "csce_gap": ["--mols", "40", "--epochs", "1"],
    "ogb_gap": ["--mols", "40", "--epochs", "1"],
    "qm9_hpo": ["--trials", "2", "--epochs", "1", "--mols", "40"],
    "lsms": ["--configs", "40", "--epochs", "1"],
}
REFUSE_ARGS = {"qm9": ["--synthetic"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    torch.set_num_threads(1)


def _reference(rel_path):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from common.loaders import load_example_module

    return load_example_module(rel_path, name="ref_" + rel_path.replace("/", "_")[:-3])


def _driver(name):
    import importlib

    return importlib.import_module(f"hydragnn_tpu_torch.drivers.{name}")


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
                assert x == y, f.name


def _smiles_reference(mod_path, types_name, target_name, n):
    """The reference drivers' sample loop (csce/ogb train_gap.py main)."""
    from hydragnn_tpu.utils.smiles import graph_sample_from_smiles, parse_smiles

    mod = _reference(mod_path)
    csce = _reference("csce/train_gap.py")
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        smi = csce.random_smiles(rng)
        mol = parse_smiles(smi)
        out.append(graph_sample_from_smiles(
            smi, [getattr(mod, target_name)(mol)], getattr(mod, types_name), mol=mol))
    return out


@pytest.mark.parametrize("native", ["native", "numpy"])
@pytest.mark.parametrize("which", ["lj", "md17", "qm9", "zinc"])
def test_generators_equal_reference(which, native, monkeypatch):
    if native == "numpy":
        monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    if which == "lj":
        got = _driver("lj_data").create_dataset(6, cutoff=5.0)
        want = _reference("LennardJones/LJ_data.py").create_dataset(6, cutoff=5.0)
    elif which == "md17":
        got = _driver("md17").synthetic_md17(12)
        want = _reference("md17/md17.py").synthetic_md17(12)
    elif which == "qm9":
        got = _driver("qm9").synthetic_qm9(30)
        want = _reference("qm9/qm9.py").synthetic_qm9(30)
    else:
        got = _driver("zinc").synthetic_zinc(20, seed=3)
        want = _reference("zinc/zinc.py").synthetic_zinc(20, seed=3)
    _same_samples(got, want)


@pytest.mark.parametrize("which", ["csce", "ogb"])
def test_smiles_samples_equal_reference(which):
    if which == "csce":
        mod = _driver("csce_gap")
        got = mod.smiles_samples(60, mod.CSCE_TYPES, mod.gap_target)
        want = _smiles_reference("csce/train_gap.py", "CSCE_TYPES", "gap_target", 60)
    else:
        mod = _driver("ogb_gap")
        got = mod.smiles_samples(60, mod.OGB_TYPES, mod.spectral_gap)
        want = _smiles_reference("ogb/train_gap.py", "OGB_TYPES", "spectral_gap", 60)
        assert mod.random_smiles is _driver("csce_gap").random_smiles
    _same_samples(got, want)


def test_lsms_files_equal_reference(tmp_path):
    from hydragnn_tpu.data.synthetic import deterministic_graph_data as ref
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    deterministic_graph_data(str(tmp_path / "port"), number_configurations=40, seed=3)
    ref(str(tmp_path / "ref"), number_configurations=40, seed=3)
    files = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == files and len(files) == 40
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "ref", files,
                                               shallow=False)
    assert not mismatch and not errors


def test_qm9_hpo_search_equals_reference(monkeypatch):
    import hydragnn_tpu.utils.hpo as ref_hpo

    seen = {}

    def record(config, space, n_trials=10, *, datasets=None, seed=0, objective=None):
        seen.update(config=config, space=space, n_trials=n_trials, seed=seed,
                    n=[len(d) for d in datasets])
        return {}, 0.0, []

    monkeypatch.setattr(ref_hpo, "random_search", record)
    monkeypatch.setattr(sys, "argv", ["qm9_hpo.py", "--trials", "3", "--epochs", "2",
                                      "--mols", "20"])
    with contextlib.redirect_stdout(None):
        _reference("qm9_hpo/qm9_hpo.py").main()
    mod = _driver("qm9_hpo")
    assert mod.hpo_config(2) == seen["config"]
    assert mod.SPACE == seen["space"]
    from hydragnn_tpu_torch.data.loader import split_dataset

    sizes = [len(d) for d in split_dataset(_driver("qm9").synthetic_qm9(20, seed=0), 0.8)]
    assert (seen["n_trials"], seen["seed"], seen["n"]) == (3, 0, sizes)


def test_chip_smoke_digests_are_the_cpu_build():
    """chip_smoke.py's [drivers] table of the generators' sha256 is what
    the port's generators build on the CPU (the card run holds its own
    build against it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_copy",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.driver_digests() == smoke.DRIVER_DIGESTS


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for k, v in value.items() if k not in ("events",))
    if isinstance(value, (list, tuple)):
        return all(_finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_main_runs_on_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mod = _driver(name.replace("_bf16", ""))
    with contextlib.redirect_stdout(None):
        out = mod.main(DRIVERS[name] + ["--device", "cpu"])
    assert out and _finite(out), out
    if name in ("lennard_jones", "md17"):
        sim = out["simulation"]
        assert sim["steps"] == 8 and sim["finite"] and sim["events"] == []
    if name == "qm9_hpo":
        assert len(out["trials"]) == 2 and out["device_mib"] == []
        assert out["best_val"] == min(v for _, v in out["trials"])


@pytest.mark.parametrize("name", sorted(n for n in DRIVERS if n != "zinc_bf16"))
def test_driver_refuses_cuda_without_a_card(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _driver(name).main(REFUSE_ARGS.get(name, []) + ["--device", "cuda"])


def test_qm9_refuses_the_real_dataset(capsys):
    with pytest.raises(SystemExit):
        _driver("qm9").main(["--device", "cpu"])
    assert "torch_geometric" in capsys.readouterr().err


def _qm9_plot_config():
    with open(os.path.join(ROOT, "examples", "qm9", "qm9.json")) as f:
        config = json.load(f)
    # one batch a split on one device: the reference compiles each step once
    config["NeuralNetwork"]["Training"].update(num_epoch=1, batch_size=32, Parallelism={
        "scheme": "single", "packing": {"enabled": False}})
    config["Visualization"] = {"create_plots": True}
    config["Verbosity"] = {"level": 0}
    return config


def _pngs(run_dir):
    return sorted(f for f in os.listdir(run_dir) if f.endswith(".png"))


def test_plot_hook_matches_reference(tmp_path, monkeypatch):
    import hydragnn_tpu
    from hydragnn_tpu.data.loader import split_dataset as ref_split
    from hydragnn_tpu.postprocess import visualizer as ref_viz
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data.loader import split_dataset
    from hydragnn_tpu_torch.postprocess import visualizer

    seen = {}

    def recording(tag, plain):
        def scatter(self, trues, preds, output_names=None):
            seen[tag] = (trues, preds, output_names)
            return plain(self, trues, preds, output_names=output_names)
        return scatter

    monkeypatch.setattr(visualizer.Visualizer, "create_scatter_plots",
                        recording("port", visualizer.Visualizer.create_scatter_plots))
    monkeypatch.setattr(ref_viz.Visualizer, "create_scatter_plots",
                        recording("ref", ref_viz.Visualizer.create_scatter_plots))

    port_sets = split_dataset(_driver("qm9").synthetic_qm9(24), 0.8)
    ref_sets = ref_split(_reference("qm9/qm9.py").synthetic_qm9(24), 0.8)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    *_, full = runner.run_training(_qm9_plot_config(), datasets=port_sets, device="cpu")
    monkeypatch.chdir(tmp_path / "ref")
    *_, ref_full = hydragnn_tpu.run_training(_qm9_plot_config(), datasets=ref_sets)

    name = full["_log_name"]
    port_pngs = _pngs(tmp_path / "port" / "logs" / name)
    assert port_pngs == _pngs(tmp_path / "ref" / "logs" / name)
    assert port_pngs == sorted(["scatter_property.png", "history.png", "num_nodes.png",
                                "error_hist_property.png", "global_analysis.png",
                                "task_history.png"])
    trues, preds, names = seen["port"]
    test_y = np.stack([s.y_graph for s in port_sets[2]])
    np.testing.assert_array_equal(trues[0], test_y)
    np.testing.assert_array_equal(trues[0], seen["ref"][0][0])
    assert names == seen["ref"][2] == ["property"]
    assert preds[0].shape == test_y.shape and np.isfinite(preds[0]).all()


def test_plot_hook_raises_without_matplotlib(tmp_path, monkeypatch):
    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data.loader import split_dataset

    monkeypatch.chdir(tmp_path)
    monkeypatch.delitem(sys.modules, "hydragnn_tpu_torch.postprocess.visualizer",
                        raising=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    config = _qm9_plot_config()
    config["NeuralNetwork"]["Architecture"].update(hidden_dim=8, num_filters=8,
                                                   num_conv_layers=1)
    with pytest.raises(ImportError):
        runner.run_training(config, datasets=split_dataset(
            _driver("qm9").synthetic_qm9(12), 0.8), device="cpu")
    # raised by the hook, after the run saved its final checkpoint
    (run,) = os.listdir(tmp_path / "logs")
    assert os.path.exists(tmp_path / "logs" / run / "checkpoint.pt")
    assert not _pngs(tmp_path / "logs" / run)
