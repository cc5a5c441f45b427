"""The port's aux utilities against the JAX package's, on the CPU.

- ``postprocess.output_denormalize``: arrays equal, a zero-range head
  included;
- ``postprocess.Visualizer``: its seven plots write the same file names
  as the JAX one for tests/test_aux.py's inputs, and importing
  ``postprocess`` does not import matplotlib;
- ``utils/hpo``: ``apply_trial`` leaves the base config alone and equals
  the reference's; ``random_search`` draws the same trial sequence (the
  same ``default_rng`` draws and de-duplication) and finds the same best
  value on tests/test_aux.py's parabola and a two-key space, for several
  seeds; ``optuna_objective`` with a stub trial object suggests the same
  names and returns the same values (``run_trial`` stubbed in both);
- ``utils/descriptors.atomicdescriptors``: the embedding tables equal,
  with and without one-hot columns, for several element sets and the
  whole Z = 1..86 table; the embedding file byte for byte, and read back
  with ``overwritten=False``;
- ``utils/lsms``: ``convert_raw_data_energy_to_gibbs``'s files byte for
  byte on tests/test_aux.py's directory and on a generated 40-file
  binary alloy at 0 K and 300 K; ``compute_formation_enthalpy`` equal;
- ``utils/time_utils``: ``print_timers``'s lines equal;
- ``utils/smiles``: ``parse_smiles`` (atoms, aromatic flags, charges,
  bonds), ``graph_sample_from_smiles``, ``generate_graphdata_from_smilestr``
  and ``molecule_from_positions`` bit for bit over tests/test_smiles.py's
  strings and 200 draws of the csce driver's ``random_smiles``; the
  malformed strings of tests/test_smiles.py raise the same exception
  types; ``smiles_featurizer_path()`` is ``"native"`` (no rdkit here).

The JAX side of these modules is numpy (matplotlib for the plots): no
network is compiled, so the file runs in a few seconds at one torch
thread.
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SMILES = [
    "C", "CC", "C=C", "C#N", "c1ccccc1", "c1ccc2ccccc2c1", "CC(=O)O", "c1ccncc1",
    "[NH4+]", "O=C=O", "ClCCl", "C/C=C/C", "C%10CC%10", "CCO.CC", "CCC", "CCCC",
    "CCO", "CCN", "CO", "C1CC1", "CC(C)C", "C=1CC=1", "[O-]C(=O)C", "BrC(Cl)F",
    "c1ccoc1", "c1ccsc1", "[13CH4]", "N#CC#N", "CSC", "FC(F)(F)F",
]
TYPES_ALL = {"C": 0, "O": 1, "N": 2, "H": 3, "Cl": 4, "Br": 5, "F": 6, "S": 7}
MALFORMED = ["C1CC", "C?C", "1CC1", "CC)C", "C=1CC-1", "[Xx]"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    torch.set_num_threads(1)


def _random_smiles_pool(n=200, seed=0):
    from hydragnn_tpu_torch.drivers.csce_gap import random_smiles

    rng = np.random.default_rng(seed)
    return [random_smiles(rng) for _ in range(n)]


# ------------------------------------------------------------ postprocess


@pytest.mark.parametrize("heads", [1, 3])
def test_output_denormalize_equals_reference(heads):
    from hydragnn_tpu.postprocess import output_denormalize as ref
    from hydragnn_tpu_torch.postprocess import output_denormalize

    rng = np.random.default_rng(heads)
    minmax = [(float(lo), float(lo) + float(w)) for lo, w in rng.normal(size=(heads, 2))]
    minmax[-1] = (2.5, 2.5)  # a zero-range head keeps scale 1
    trues = [rng.normal(size=(7, 2)).astype(np.float32) for _ in range(heads)]
    preds = [rng.normal(size=(7, 2)).astype(np.float32) for _ in range(heads)]
    got, want = output_denormalize(minmax, trues, preds), ref(minmax, trues, preds)
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_postprocess_import_leaves_matplotlib_out():
    import subprocess

    code = ("import sys; import hydragnn_tpu_torch.postprocess as p; "
            "assert 'matplotlib' not in sys.modules; p.output_denormalize; "
            "assert 'matplotlib' not in sys.modules; p.Visualizer; "
            "assert 'matplotlib' in sys.modules")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def _draw_all_plots(viz_cls, graph_sample_cls):
    viz = viz_cls("viztest", num_heads=1)
    t = [np.random.default_rng(0).normal(size=(50, 1))]
    p = [t[0] + 0.1]
    viz.create_scatter_plots(t, p, output_names=["energy"])
    viz.plot_history([1.0, 0.5, 0.2], [1.1, 0.6, 0.3], [1.2, 0.7, 0.4])
    viz.num_nodes_plot([[graph_sample_cls(x=np.zeros((n, 1), np.float32)) for n in (3, 4, 5)]],
                       ["train"])
    rng = np.random.default_rng(1)
    viz.create_error_histograms(t, p, output_names=["energy"])
    viz.create_plot_global(t, p, output_names=["energy"])
    viz.create_parity_plot_vector(rng.normal(size=(40, 3)), rng.normal(size=(40, 3)),
                                  name="forces")
    viz.plot_task_history(
        [np.array([1.0, 0.5]), np.array([0.8, 0.4]), np.array([0.6, 0.3])],
        task_names=["energy", "forces"])


def test_visualizer_writes_the_reference_files(tmp_path, monkeypatch):
    from hydragnn_tpu.data.graph import GraphSample as RefSample
    from hydragnn_tpu.postprocess import Visualizer as RefViz
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.postprocess import Visualizer

    names = {}
    for tag, viz, sample in (("ref", RefViz, RefSample), ("port", Visualizer, GraphSample)):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        _draw_all_plots(viz, sample)
        names[tag] = sorted(os.listdir(tmp_path / tag / "logs" / "viztest"))
    assert names["port"] == names["ref"]
    assert names["port"] == sorted([
        "scatter_energy.png", "history.png", "num_nodes.png", "error_hist_energy.png",
        "global_analysis.png", "parity_forces.png", "task_history.png"])


# ------------------------------------------------------------------- hpo


def test_apply_trial_equals_reference():
    from hydragnn_tpu.utils import hpo as ref
    from hydragnn_tpu_torch.utils import hpo

    config = {"NeuralNetwork": {"Architecture": {"hidden_dim": 8},
                                "Training": {"Optimizer": {"learning_rate": 1e-3}}}}
    params = {"NeuralNetwork.Architecture.hidden_dim": 32,
              "NeuralNetwork.Training.Optimizer.learning_rate": 3e-4,
              "NeuralNetwork.Architecture.new.deep": [1, 2]}
    got = hpo.apply_trial(config, params)
    assert got == ref.apply_trial(config, params)
    assert config["NeuralNetwork"]["Architecture"] == {"hidden_dim": 8}


SPACES = {
    "parabola": {"NeuralNetwork.Architecture.hidden_dim": [4, 8, 16, 32]},
    "qm9_hpo": {
        "NeuralNetwork.Architecture.hidden_dim": [16, 32, 64],
        "NeuralNetwork.Architecture.num_conv_layers": [2, 3, 4],
        "NeuralNetwork.Training.Optimizer.learning_rate": [3e-3, 1e-3, 3e-4],
        "NeuralNetwork.Architecture.mpnn_type": ["SchNet", "PNA"],
    },
}


def _objective(cfg, params):
    h = params["NeuralNetwork.Architecture.hidden_dim"]
    value = float((h - 16) ** 2)
    lr = params.get("NeuralNetwork.Training.Optimizer.learning_rate")
    if lr is not None:
        value += 1e3 * abs(np.log10(lr) + 3.0) + params[
            "NeuralNetwork.Architecture.num_conv_layers"]
    return value


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_search_draws_the_reference_sequence(space, seed):
    from hydragnn_tpu.utils.hpo import random_search as ref
    from hydragnn_tpu_torch.utils.hpo import random_search

    config = {"NeuralNetwork": {"Architecture": {"hidden_dim": 8}}}
    got = random_search(config, SPACES[space], n_trials=20, seed=seed, objective=_objective)
    want = ref(config, SPACES[space], n_trials=20, seed=seed, objective=_objective)
    assert got == want
    if space == "parabola":
        assert got[0]["NeuralNetwork.Architecture.hidden_dim"] == 16 and got[1] == 0


class _StubTrial:
    """Optuna's trial interface, as optuna_objective uses it: picks the
    choice at a fixed position and records the names asked for."""

    def __init__(self, pick):
        self.pick = pick
        self.asked = []

    def suggest_categorical(self, name, choices):
        self.asked.append((name, tuple(choices)))
        return choices[self.pick % len(choices)]


@pytest.mark.parametrize("pick", [0, 1, 2])
def test_optuna_objective_equals_reference(pick, monkeypatch):
    from hydragnn_tpu.utils import hpo as ref
    from hydragnn_tpu_torch.utils import hpo

    calls = {"ref": [], "port": []}
    monkeypatch.setattr(ref, "run_trial", lambda c, p, datasets=None: (
        calls["ref"].append(p), _objective(c, p))[1])
    monkeypatch.setattr(hpo, "run_trial", lambda c, p, datasets=None, device=None: (
        calls["port"].append(p), _objective(c, p))[1])
    space = SPACES["qm9_hpo"]
    t_ref, t_port = _StubTrial(pick), _StubTrial(pick)
    v_ref = ref.optuna_objective({}, space)(t_ref)
    v_port = hpo.optuna_objective({}, space)(t_port)
    assert v_port == v_ref
    assert t_port.asked == t_ref.asked
    assert calls["port"] == calls["ref"]


# ----------------------------------------------------------- descriptors


@pytest.mark.parametrize("elements", [("C", "H", "O", "N", "F", "S"), ("C", "H", "O"),
                                      ("Fe", "Pt"), ("Li", "Na", "K", "Rb", "Cs", "He"), None])
@pytest.mark.parametrize("one_hot", [False, True])
def test_atomicdescriptors_equal_reference(elements, one_hot, tmp_path):
    from hydragnn_tpu.utils.descriptors import atomicdescriptors as ref
    from hydragnn_tpu_torch.utils.descriptors import atomicdescriptors

    kw = dict(element_types=elements, one_hot=one_hot)
    f_port, f_ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    got = atomicdescriptors(embeddingfilename=f_port, **kw)
    want = ref(embeddingfilename=f_ref, **kw)
    assert list(got.atom_embeddings) == list(want.atom_embeddings)
    for z in want.atom_embeddings:
        np.testing.assert_array_equal(np.asarray(got.atom_embeddings[z]),
                                      np.asarray(want.atom_embeddings[z]))
        np.testing.assert_array_equal(got.get_atom_features(int(z)),
                                      want.get_atom_features(int(z)))
    with open(f_port, "rb") as a, open(f_ref, "rb") as b:
        assert a.read() == b.read()
    back = atomicdescriptors(embeddingfilename=f_port, overwritten=False)
    assert back.atom_embeddings == json.load(open(f_ref))
    if elements:
        sym = elements[0]
        np.testing.assert_array_equal(got.get_atom_features(sym),
                                      want.get_atom_features(sym))


def test_atomicdescriptors_refuse_elements_outside_the_table():
    from hydragnn_tpu.utils.descriptors import atomicdescriptors as ref
    from hydragnn_tpu_torch.utils.descriptors import atomicdescriptors

    for fn in (ref, atomicdescriptors):
        with pytest.raises(ValueError, match="no property data"):
            fn(element_types=["C", "U"])


# ------------------------------------------------------------------ lsms


def _write_lsms(d, name, rows, energy):
    lines = [f"{energy}"] + [" ".join(str(v) for v in r) for r in rows]
    (d / name).write_text("\n".join(lines) + "\n")


def _aux_dir(d):
    """tests/test_aux.py's directory: two pure configurations and one
    50/50 mix."""
    _write_lsms(d, "pure0.txt", [[0, 0, 0, 0, 0], [0, 1, 0.5, 0.5, 0.5]], -2.0)
    _write_lsms(d, "pure1.txt", [[1, 0, 0, 0, 0], [1, 1, 0.5, 0.5, 0.5]], -4.0)
    _write_lsms(d, "mix.txt", [[0, 0, 0, 0, 0], [1, 1, 0.5, 0.5, 0.5]], -3.5)
    return [0.0, 1.0]


def _alloy_dir(d):
    """40 FePt configurations of 4-16 atoms (two of them pure), with
    positions and an extra column, energies near a linear mixing line."""
    rng = np.random.default_rng(5)
    for i in range(40):
        n = int(rng.integers(4, 17))
        if i < 2:
            species = np.full(n, (26.0, 78.0)[i])
        else:
            species = rng.choice([26.0, 78.0], n)
        pos = rng.uniform(0, 4, (n, 3))
        rows = [[s, j, *np.round(p, 6), round(float(rng.normal()), 6)]
                for j, (s, p) in enumerate(zip(species, pos))]
        energy = float(-3.0 * (species == 26.0).sum() - 5.5 * (species == 78.0).sum()
                       + rng.normal(scale=0.2))
        _write_lsms(d, f"conf{i:03d}.txt", rows, f"{energy} 0.25")
    return [26.0, 78.0]


@pytest.mark.parametrize("case,temperature", [("aux", 0.0), ("alloy", 0.0), ("alloy", 300.0)])
def test_gibbs_conversion_byte_equal(case, temperature, tmp_path):
    from hydragnn_tpu.utils.lsms import convert_raw_data_energy_to_gibbs as ref
    from hydragnn_tpu_torch.utils.lsms import convert_raw_data_energy_to_gibbs

    outs = {}
    for tag, fn in (("ref", ref), ("port", convert_raw_data_energy_to_gibbs)):
        d = tmp_path / tag / "lsms"
        d.mkdir(parents=True)
        elements = (_aux_dir if case == "aux" else _alloy_dir)(d)
        outs[tag] = fn(str(d), elements, temperature_kelvin=temperature)
    files = sorted(os.listdir(outs["ref"]))
    assert sorted(os.listdir(outs["port"])) == files and files
    for f in files:
        with open(os.path.join(outs["port"], f), "rb") as a, \
                open(os.path.join(outs["ref"], f), "rb") as b:
            assert a.read() == b.read(), f


def test_gibbs_conversion_refuses_like_reference(tmp_path):
    from hydragnn_tpu.utils.lsms import convert_raw_data_energy_to_gibbs as ref
    from hydragnn_tpu_torch.utils.lsms import convert_raw_data_energy_to_gibbs

    for tag, fn in (("ref", ref), ("port", convert_raw_data_energy_to_gibbs)):
        d = tmp_path / tag / "lsms"
        d.mkdir(parents=True)
        _aux_dir(d)
        fn(str(d), [0.0, 1.0])
        with pytest.raises(FileExistsError):
            fn(str(d), [0.0, 1.0])
        (d / "pure1.txt").unlink()
        with pytest.raises(ValueError, match="pure-element"):
            fn(str(d), [0.0, 1.0], overwrite_data=True)


def test_formation_enthalpy_equals_reference():
    from hydragnn_tpu.utils.lsms import compute_formation_enthalpy as ref
    from hydragnn_tpu_torch.utils.lsms import compute_formation_enthalpy

    rng = np.random.default_rng(2)
    pure = {26.0: -3.1, 78.0: -5.4}
    for n in (1, 5, 12, 31):
        atoms = np.c_[rng.choice([26.0, 78.0], n), rng.normal(size=(n, 4))]
        energy = float(rng.normal(-4.0 * n, 1.0))
        assert compute_formation_enthalpy([78.0, 26.0], pure, energy, atoms) == ref(
            [78.0, 26.0], pure, energy, atoms)


# ------------------------------------------------------------ time_utils


def test_print_timers_lines_equal_reference():
    from hydragnn_tpu.utils import time_utils as ref
    from hydragnn_tpu_torch.utils import Timer, print_timers, time_utils

    lines = {}
    for tag, mod, timer, show in (("ref", ref, ref.Timer, ref.print_timers),
                                  ("port", time_utils, Timer, print_timers)):
        mod.reset_timers()
        with timer("b_inner"):
            pass
        t = timer("a_outer")
        t.start()
        t.stop()
        t.total, t.count = 1.23456789, 3
        mod._TIMERS["b_inner"].total = 0.5
        buf = io.StringIO()
        with redirect_stdout(buf):
            show(1)
            show(0)  # below the threshold: nothing
        lines[tag] = buf.getvalue()
        mod.reset_timers()
    assert lines["port"] == lines["ref"]
    assert lines["port"].splitlines() == [
        "timer a_outer: total 1.2346s count 3 avg 0.4115s",
        "timer b_inner: total 0.5000s count 1 avg 0.5000s"]


# ---------------------------------------------------------------- SMILES


def _same_mol(a, b):
    assert a.symbols == b.symbols
    assert a.atomic_numbers == b.atomic_numbers
    assert a.aromatic == b.aromatic
    assert a.charges == b.charges
    assert a.bonds == b.bonds


def _same_sample(a, b):
    for name in ("x", "edge_index", "edge_attr", "y_graph", "y_node", "pos"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("pool", ["test_smiles", "random_smiles"])
def test_smiles_graphs_bit_for_bit(pool):
    from hydragnn_tpu.utils import descriptors as ref_desc
    from hydragnn_tpu.utils import smiles as ref
    from hydragnn_tpu_torch.utils import descriptors, smiles

    strings = SMILES if pool == "test_smiles" else _random_smiles_pool()
    for k, smi in enumerate(strings):
        for with_h in (True, False):
            _same_mol(smiles.parse_smiles(smi, with_hydrogen=with_h),
                      ref.parse_smiles(smi, with_hydrogen=with_h))
        y = [0.25 * k, -1.0]
        for graph_target in (True, False):
            _same_sample(smiles.graph_sample_from_smiles(smi, y, TYPES_ALL,
                                                         graph_target=graph_target),
                         ref.graph_sample_from_smiles(smi, y, TYPES_ALL,
                                                      graph_target=graph_target))
        _same_sample(descriptors.generate_graphdata_from_smilestr(smi, y, TYPES_ALL),
                     ref_desc.generate_graphdata_from_smilestr(smi, y, TYPES_ALL))


def test_molecule_from_positions_bit_for_bit():
    from hydragnn_tpu.utils import smiles as ref
    from hydragnn_tpu_torch.utils import smiles

    cases = [
        ([[0, 0, 0], [1.54, 0, 0]], [6, 6]),
        ([[0, 0, 0], [1.33, 0, 0]], [6, 6]),
        ([[0, 0, 0], [1.20, 0, 0]], [6, 6]),
        ([[0, 0, 0], [1.16, 0, 0], [-1.16, 0, 0]], [6, 8, 8]),
        ([[0.0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]], [8, 1, 1]),
        ([[0.0, 0.0, 0.0], [1.80, 0.0, 0.0]], [26, 8]),
        ([[0.0, 0.0, 0.0], [2.00, 0.0, 0.0]], [14, 14]),
    ]
    rng = np.random.default_rng(4)
    for _ in range(20):
        n = int(rng.integers(3, 12))
        cases.append((rng.uniform(0, 3.0, (n, 3)), rng.choice([1, 6, 7, 8, 16, 26], n)))
    for pos, z in cases:
        got = smiles.molecule_from_positions(np.asarray(pos, float), z)
        want = ref.molecule_from_positions(np.asarray(pos, float), z)
        _same_mol(got, want)
        if all(s in TYPES_ALL for s in got.symbols):
            _same_sample(smiles.graph_sample_from_smiles("", [1.0], TYPES_ALL, mol=got),
                         ref.graph_sample_from_smiles("", [1.0], TYPES_ALL, mol=want))
    with pytest.raises(ValueError):
        smiles.molecule_from_positions(np.zeros((2, 3)), [6])


@pytest.mark.parametrize("bad", MALFORMED)
def test_smiles_errors_raise_the_reference_types(bad):
    from hydragnn_tpu.utils import smiles as ref
    from hydragnn_tpu_torch.utils import smiles

    with pytest.raises(Exception) as want:
        ref.parse_smiles(bad)
    with pytest.raises(want.type):
        smiles.parse_smiles(bad)


def test_smiles_unknown_type_and_names_equal_reference():
    from hydragnn_tpu.utils import descriptors as ref_desc
    from hydragnn_tpu.utils import smiles as ref
    from hydragnn_tpu_torch.utils import descriptors, smiles

    types = {"C": 0, "O": 1, "N": 2, "H": 3}
    with pytest.raises(KeyError, match="not in the `types` map"):
        smiles.graph_sample_from_smiles("CS", [0.0], types)
    assert smiles.get_node_attribute_name(types) == ref.get_node_attribute_name(types)
    assert descriptors.get_node_attribute_name(["C", "H"]) == \
        ref_desc.get_node_attribute_name(["C", "H"])
    assert descriptors.smiles_featurizer_path() == ref_desc.smiles_featurizer_path() == "native"
