"""Dataset formats, the shared-memory sample store and the native cell
list of the port, against the JAX package, on the CPU.

- ``.hgb`` containers: the port's file equals the JAX writer's byte for
  byte, each package reads the other's file sample for sample, and the
  header's answers (``field_widths``, ``label_fields``,
  ``sample_sizes``, ``attrs``) equal the reference's; direct and
  preloaded reads, ``subset``, sharded files, the writer's refusals, the
  ``smiles_featurizer`` stamp check;
- ``pack_sample`` records equal the JAX package's byte for byte; the
  native ``SampleStore`` in private and in shared memory, attach, and
  attach failing once the owner closed;
- the port's pickle reader on a directory the JAX package wrote (in a
  child process that must import neither ``jax`` nor ``hydragnn_tpu``),
  the meta's field map and the scan fallback;
- the XYZ and CFG readers, ``stratified_sample`` and the energy baseline
  equal to the reference's bit for bit;
- the native cell list: the port's edges equal its numpy path as sets,
  and the JAX package's native path element for element (open and
  periodic, ``max_neighbours``); with ``HYDRAGNN_TPU_NO_NATIVE=1`` the
  JAX package's numpy path;
- the dataset-wide optional-field map: a dataset with ``edge_attr`` on
  some samples gives the JAX loader's batches (through the serial feed
  and the workers), and one with ``forces`` on some is refused with the
  reference's error;
- a ``GraphLoader`` over a counting container reads no sample at
  construction (nor do ``dataset_size_arrays``, one-process
  ``shard_dataset_for_process`` and the runner's node bound), and its
  batches equal the list-fed ones bit for bit;
- ``run_training`` on ``Dataset.format: "binary"`` (a small SchNet, as
  tests/test_binformat.py configures it, on the single scheme) against the JAX package's run
  on the same files from the same initial parameters: per-epoch losses
  within rtol 1e-5 / atol 1e-4 (each atol scaled by the reference's
  magnitude where that is below 1); the port's pickle, XYZ and CFG runs
  equal its runs fed the same samples as lists, bit for bit.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
F32_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import native, runner
    from hydragnn_tpu_torch.data import (
        binformat,
        diststore,
        energy_regression,
        formats,
        graph,
        loader,
        padschedule,
        pickledataset,
        pipeline,
        sampling,
    )
    from hydragnn_tpu_torch.ops import neighbors
    from hydragnn_tpu_torch.parallel import runtime

    return types.SimpleNamespace(
        torch=torch, native=native, runner=runner, binformat=binformat,
        diststore=diststore, energy=energy_regression, formats=formats, graph=graph,
        loader=loader, padschedule=padschedule, pickle=pickledataset,
        pipeline=pipeline, sampling=sampling, neighbors=neighbors, runtime=runtime)


@pytest.fixture(scope="module")
def ref():
    import tests._cpu  # noqa: F401
    from hydragnn_tpu.data import (
        binformat,
        diststore,
        energy_regression,
        formats,
        graph,
        loader,
        pickledataset,
        sampling,
    )
    from hydragnn_tpu.ops import neighbors

    return types.SimpleNamespace(
        binformat=binformat, diststore=diststore, energy=energy_regression,
        formats=formats, graph=graph, loader=loader, pickle=pickledataset,
        sampling=sampling, neighbors=neighbors)


def _fields(n, seed=0, with_energy=True):
    """tests/test_binformat.py's samples, as constructor keywords."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(r.integers(3, 8))
        e = int(r.integers(2, 10))
        out.append(dict(
            x=r.normal(size=(k, 2)).astype(np.float32),
            pos=r.normal(size=(k, 3)).astype(np.float32),
            edge_index=r.integers(0, k, (2, e)).astype(np.int64),
            edge_attr=r.normal(size=(e, 1)).astype(np.float32),
            y_graph=np.array([float(i)], np.float32),
            y_node=r.normal(size=(k, 1)).astype(np.float32),
            cell=np.eye(3, dtype=np.float32) * (i + 1),
            energy=float(-i) if with_energy else None,
            dataset_id=i % 3,
        ))
    return out


def _make(cls, fields):
    return [cls(**f) for f in fields]


def _same_sample(a, b):
    for f in ("x", "pos", "edge_index", "edge_attr", "edge_shifts", "y_graph", "y_node",
              "graph_attr", "pe", "rel_pe", "cell", "forces"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f
    assert a.dataset_id == b.dataset_id
    assert (a.energy is None) == (b.energy is None)
    if a.energy is not None:
        assert a.energy == b.energy


def _same_batch(a, b, names=None):
    import torch

    fa, fb = a.arrays(), b.arrays()
    names = names or set(fa) | set(fb)
    for k in names:
        va, vb = fa.get(k), fb.get(k)
        assert (va is None) == (vb is None), k
        if va is not None:
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype and np.array_equal(va, vb), k


# -------------------------------------------------------------- containers
def test_bin_bytes_cross_reads_and_header(port, ref, tmp_path):
    fields = _fields(12)
    attrs = {"minmax": [0.0, 1.0], "avg_num_neighbors": 5.5, "pna_deg": [0, 2, 3]}
    pj, pt = str(tmp_path / "j.hgb"), str(tmp_path / "t.hgb")
    ref.binformat.write_bin_dataset(pj, _make(ref.graph.GraphSample, fields), attrs=attrs)
    port.binformat.write_bin_dataset(pt, _make(port.graph.GraphSample, fields), attrs=attrs)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file
    tj, jt = port.binformat.BinDataset(pj), ref.binformat.BinDataset(pt)
    assert len(tj) == len(jt) == 12
    for i in range(12):
        assert isinstance(tj[i], port.graph.GraphSample)
        _same_sample(tj[i], jt[i])
    assert tj.attrs == jt.attrs == attrs
    assert (tj.pna_deg, tj.avg_num_neighbors, tj.minmax) == ([0, 2, 3], 5.5, [0.0, 1.0])
    assert tj.field_widths() == jt.field_widths() == ref.graph.optional_field_widths(
        _make(ref.graph.GraphSample, fields))
    assert tj.label_fields() == jt.label_fields()
    for a, b in zip(tj.sample_sizes(), jt.sample_sizes()):
        assert np.array_equal(a, b)
    # preload with a subset
    sub = port.binformat.BinDataset(pt, preload=True, subset=[2, 7, 9])
    assert len(sub) == 3 and [len(x) for x in sub.sample_sizes()] == [3, 3]
    _same_sample(sub[1], tj[7])


def test_bin_optional_fields_refusals_and_shards(port, ref, tmp_path):
    fields = _fields(4, with_energy=False)
    for f in fields:
        f["edge_attr"] = f["cell"] = None
    p = str(tmp_path / "opt.hgb")
    port.binformat.write_bin_dataset(p, _make(port.graph.GraphSample, fields))
    ds = port.binformat.BinDataset(p)
    assert ds[0].energy is None and ds[0].edge_attr is None and ds[0].cell is None
    assert ds.field_widths() == {}
    partial = _fields(3)
    partial[1]["edge_attr"] = None
    with pytest.raises(ValueError, match="only some"):
        port.binformat.write_bin_dataset(str(tmp_path / "bad.hgb"),
                                         _make(port.graph.GraphSample, partial))
    (tmp_path / "junk.hgb").write_bytes(b"not a container")
    with pytest.raises(ValueError, match="not a HGTPUBIN1"):
        port.binformat.BinDataset(str(tmp_path / "junk.hgb"))
    # shards written by each package, opened as one dataset
    all_fields = _fields(10, seed=3)
    stem = str(tmp_path / "shards")
    ref.binformat.write_bin_dataset(f"{stem}.p0.hgb", _make(ref.graph.GraphSample,
                                                            all_fields[:6]), attrs={"a": 1})
    port.binformat.write_bin_dataset(f"{stem}.p1.hgb", _make(port.graph.GraphSample,
                                                             all_fields[6:]), attrs={"b": 2})
    multi = port.binformat.BinDataset.open_sharded(stem)
    jmulti = ref.binformat.BinDataset.open_sharded(stem)
    assert isinstance(multi, port.binformat.MultiBinDataset) and len(multi) == 10
    assert multi.attrs == jmulti.attrs == {"a": 1, "b": 2}
    for i in range(10):
        _same_sample(multi[i], jmulti[i])
    assert multi.field_widths() == jmulti.field_widths()
    for a, b in zip(multi.sample_sizes(), jmulti.sample_sizes()):
        assert np.array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        port.binformat.BinDataset.open_sharded(str(tmp_path / "none"))
    # shards featurized by different SMILES paths are refused
    a, b, c = (str(tmp_path / f"{k}.hgb") for k in "abc")
    samples = _make(port.graph.GraphSample, _fields(4))
    port.binformat.write_bin_dataset(a, samples, attrs={"smiles_featurizer": "rdkit"})
    port.binformat.write_bin_dataset(b, samples, attrs={"smiles_featurizer": "native"})
    port.binformat.write_bin_dataset(c, samples, attrs={"smiles_featurizer": "rdkit"})
    with pytest.raises(ValueError, match="smiles_featurizer"):
        port.binformat.MultiBinDataset([port.binformat.BinDataset(a),
                                        port.binformat.BinDataset(b)])
    assert len(port.binformat.MultiBinDataset([port.binformat.BinDataset(a),
                                               port.binformat.BinDataset(c)])) == 8


def test_field_widths_multi_lazily_and_label_divergence(port, tmp_path):
    g = port.graph
    train, val = _make(g.GraphSample, _fields(8, seed=1)), _make(g.GraphSample, _fields(4, 2))
    p1, p2 = str(tmp_path / "t.hgb"), str(tmp_path / "v.hgb")
    port.binformat.write_bin_dataset(p1, train)
    port.binformat.write_bin_dataset(p2, val)
    d1, d2 = port.binformat.BinDataset(p1), port.binformat.BinDataset(p2)
    loads = []
    orig = port.binformat.BinDataset._load
    port.binformat.BinDataset._load = lambda self, i: loads.append(i) or orig(self, i)
    try:
        merged = g.optional_field_widths_multi([d1, d2, []])
    finally:
        port.binformat.BinDataset._load = orig
    assert merged == g.optional_field_widths(train) and loads == []
    bad = _make(g.GraphSample, _fields(4, seed=3))
    for s in bad:
        s.y_node = None
    p3 = str(tmp_path / "bad.hgb")
    port.binformat.write_bin_dataset(p3, bad)
    with pytest.raises(ValueError, match="differ across datasets"):
        g.optional_field_widths_multi([d1, port.binformat.BinDataset(p3)])
    widths = [dict(f, edge_attr=np.zeros((f["edge_index"].shape[1], 2), np.float32))
              if i == 1 else f for i, f in enumerate(_fields(3))]
    with pytest.raises(ValueError, match="Inconsistent edge_attr widths"):
        g.optional_field_widths(_make(g.GraphSample, widths))


def test_pack_sample_and_store(port, ref):
    fields = _fields(5, seed=4)
    fields[2]["energy"] = None
    for f in fields[3:]:
        f["forces"] = np.ones_like(f["pos"])
    for tf, jf in zip(_make(port.graph.GraphSample, fields), _make(ref.graph.GraphSample, fields)):
        rec = port.diststore.pack_sample(tf)
        assert rec == ref.diststore.pack_sample(jf)
        _same_sample(port.diststore.unpack_sample(rec), tf)
        _same_sample(port.diststore.unpack_sample(rec), ref.diststore.unpack_sample(rec))
    assert port.native.available(), port.native.build_error
    recs = [os.urandom(k) for k in (1, 100, 0, 4096)]
    st = port.native.SampleStore([len(r) for r in recs])
    with pytest.raises(ValueError):
        st.put(1, recs[1])  # records go in index order
    for i, r in enumerate(recs):
        st.put(i, r)
    assert len(st) == 4 and [st.get(i) for i in range(4)] == recs
    with pytest.raises(IndexError):
        st.get(99)
    st.close()
    samples = _make(port.graph.GraphSample, fields)
    name = f"/hgtpu_torch_pytest_{os.getpid()}"
    ds = port.diststore.StoreDataset.build(samples, shm_name=name)
    with pytest.raises(RuntimeError):
        port.native.SampleStore([1], shm_name=name)  # the name is taken
    view = port.diststore.StoreDataset.attach(name)
    assert len(view) == len(ds) == 5
    for i in range(5):
        _same_sample(view[i], samples[i])
    view.close()
    ds.close()
    with pytest.raises(RuntimeError, match="cannot attach"):
        port.diststore.StoreDataset.attach(name)


def test_pickle_reads_jax_directory(port, ref, tmp_path):
    fields = _fields(6, seed=7)
    jsamples = _make(ref.graph.GraphSample, fields)
    full = str(tmp_path / "full")
    ref.pickle.SimplePickleWriter(jsamples, full, use_subdir=True, attrs={"pna_deg": [1, 2]})
    ds = port.pickle.SimplePickleDataset(full)
    assert len(ds) == 6 and ds.attrs == {"pna_deg": [1, 2]}
    scan = ref.graph.optional_field_widths(jsamples)
    assert ds.field_widths() == scan == port.graph.optional_field_widths(ds)
    for i in range(6):
        assert type(ds[i]) is port.graph.GraphSample
        _same_sample(ds[i], jsamples[i])
    assert type(ds[-1]) is port.graph.GraphSample
    with pytest.raises(IndexError):
        ds[6]
    # a shard writer leaves the map out: one scan, cached on the dataset
    shard = str(tmp_path / "shard")
    ref.pickle.SimplePickleWriter(jsamples[:3], shard, total=6, write_meta=True)
    port.pickle.SimplePickleWriter(_make(port.graph.GraphSample, fields[3:]), shard,
                                   offset=3, write_meta=False)
    ds2 = port.pickle.SimplePickleDataset(shard)
    assert ds2.field_widths() is None
    assert port.graph.optional_field_widths(ds2) == scan == ds2._cached_field_widths
    # the JAX package's other classes are not resolved by the port's reader
    bad = str(tmp_path / "bad")
    port.pickle.SimplePickleWriter(_make(port.graph.GraphSample, fields[:1]), bad)
    with open(os.path.join(bad, "sample-0.pkl"), "wb") as f:
        pickle.dump(ref.graph.PadSpec(8, 8, 2), f)
    with pytest.raises(pickle.UnpicklingError, match="hydragnn_tpu"):
        port.pickle.SimplePickleDataset(bad)[0]
    # a process with the port only reads the JAX package's pickles and
    # .hgb files without importing jax or hydragnn_tpu
    hgb = str(tmp_path / "j.hgb")
    ref.binformat.write_bin_dataset(hgb, jsamples)
    code = (
        "import sys\n"
        "from hydragnn_tpu_torch.data.pickledataset import SimplePickleDataset\n"
        "from hydragnn_tpu_torch.data.binformat import BinDataset\n"
        f"a = [s.x.sum() for s in SimplePickleDataset({full!r})]\n"
        f"b = [s.x.sum() for s in BinDataset({hgb!r})]\n"
        "assert a == b, (a, b)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'hydragnn_tpu')\n"
        "       or m.startswith(('jax.', 'hydragnn_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(a))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert done.returncode == 0 and done.stdout.strip() == "ok 6", done.stderr


# -------------------------------------------------------------- raw files
def _write_raw(root):
    os.makedirs(root / "xyz")
    os.makedirs(root / "cfg")
    rng = np.random.default_rng(11)
    for k in range(6):
        n = int(rng.integers(3, 7))
        sym = rng.choice(["O", "H", "c", "8", "Ni"], size=n)
        pos = rng.uniform(0, 3.0, (n, 3))
        rows = "\n".join(f"{s} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for s, p in zip(sym, pos))
        (root / "xyz" / f"m{k}.xyz").write_text(f"{n}\n\n{rows}\n")
        (root / "xyz" / f"m{k}_energy.txt").write_text(f"{-76.4 + k} extra\n")
        a = 3.0 + 0.25 * k
        head = (f"Number of particles = {n}\nA = 1.0 Angstrom\n"
                + "".join(f"H0({i},{j}) = {a if i == j else 0.1 * (i < j)}\n"
                          for i in (1, 2, 3) for j in (1, 2, 3))
                + ".NO_VELOCITY.\nentry_count = 5\nauxiliary[0] = c_peratom\n"
                  "auxiliary[1] = fx\n55.85\nFe\n")
        frac = rng.uniform(0, 1, (n, 3))
        aux = rng.normal(size=(n, 2))
        body = "\n".join(" ".join(f"{v:.6f}" for v in (*f, *x)) for f, x in zip(frac, aux))
        (root / "cfg" / f"s{k}.cfg").write_text(head + body + "\n")
        (root / "cfg" / f"s{k}.bulk").write_text(f"{120.0 + k}\n")


def test_xyz_cfg_readers_match_reference(port, ref, tmp_path):
    _write_raw(tmp_path)
    for name, attr in (("xyz", "read_xyz_directory"), ("cfg", "read_cfg_directory")):
        got = getattr(port.formats, attr)(str(tmp_path / name))
        want = getattr(ref.formats, attr)(str(tmp_path / name))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            _same_sample(a, b)
    s = port.formats.read_cfg_file(str(tmp_path / "cfg" / "s0.cfg"))
    assert s.x.shape[1] == 4 and np.array_equal(s.x[:, 0], np.full(len(s.x), 26.0))
    (tmp_path / "bad.xyz").write_text("1\nc\nQq 0 0 0\n")
    with pytest.raises(ValueError, match="unknown element"):
        port.formats.read_xyz_file(str(tmp_path / "bad.xyz"))
    assert port.formats.ATOMIC_NUMBERS == ref.formats.ATOMIC_NUMBERS


def test_stratified_sample_and_energy_baseline_bitwise(port, ref):
    rng = np.random.default_rng(0)
    fields = []
    for _ in range(40):
        zs = rng.choice([1.0, 6.0, 8.0, 26.0], size=int(rng.integers(2, 6)))
        fields.append(dict(x=zs.reshape(-1, 1).astype(np.float32),
                           energy=float(rng.normal(-100.0, 5.0))))
    ts, js = _make(port.graph.GraphSample, fields), _make(ref.graph.GraphSample, fields)
    for perc, seed in ((0.3, 0), (1.0, 5)):
        got = port.sampling.stratified_sample(ts, perc, seed=seed)
        want = ref.sampling.stratified_sample(js, perc, seed=seed)
        t_at, j_at = {id(s): i for i, s in enumerate(ts)}, {id(s): i for i, s in enumerate(js)}
        assert [t_at[id(s)] for s in got] == [j_at[id(s)] for s in want]
    with pytest.raises(ValueError):
        port.sampling.stratified_sample(ts, 0.0)
    coeff = port.energy.fit_energy_baseline(ts)
    assert np.array_equal(coeff, ref.energy.fit_energy_baseline(js))
    assert np.array_equal(port.energy.element_counts(ts), ref.energy.element_counts(js))
    sub_t = port.energy.subtract_energy_baseline(ts, coeff)
    sub_j = ref.energy.subtract_energy_baseline(js, coeff)
    assert [s.energy for s in sub_t] == [s.energy for s in sub_j]
    res = np.array([s.energy for s in sub_t])
    assert np.array_equal(port.energy.apply_energy_baseline(ts, res, coeff),
                          ref.energy.apply_energy_baseline(js, res, coeff))
    a = np.array([[1.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    b = np.array([1.0, 2.0])
    assert np.array_equal(port.energy.solve_least_squares_svd(a, b),
                          ref.energy.solve_least_squares_svd(a, b))


# ------------------------------------------------------------ cell list
def _canon(ei, sh=None):
    keys = (ei[1], ei[0]) if sh is None else (sh[:, 2], sh[:, 1], sh[:, 0], ei[1], ei[0])
    idx = np.lexsort(keys)
    return ei[:, idx], (None if sh is None else sh[idx])


def test_native_cell_list_against_numpy_and_jax(port, ref, monkeypatch):
    from hydragnn_tpu import native as jnative

    assert port.native.available(), port.native.build_error
    assert jnative.available()
    monkeypatch.delenv("HYDRAGNN_TPU_NO_NATIVE", raising=False)
    rng = np.random.default_rng(3)
    cell = np.array([[5.0, 0, 0], [0.7, 4.5, 0], [0.1, 0.4, 5.5]])
    cases = []
    for n in (1, 2, 17, 300):
        pos = rng.uniform(0, 5.0, (n, 3))
        for cap in (None, 6):
            native = port.neighbors.radius_graph(pos, 1.4, max_neighbours=cap)
            assert np.array_equal(native, ref.neighbors.radius_graph(pos, 1.4,
                                                                     max_neighbours=cap))
            cases.append(("open", native, None, lambda pos=pos, cap=cap: (
                port.neighbors.radius_graph(pos, 1.4, max_neighbours=cap), None),
                lambda pos=pos, cap=cap: (ref.neighbors.radius_graph(
                    pos, 1.4, max_neighbours=cap), None)))
    for pbc in [(True, True, True), (True, False, True), (False,) * 3]:
        pos = rng.uniform(-3, 8.0, (40, 3))
        ei, sh = port.neighbors.radius_graph_pbc(pos, cell, 1.6, pbc=pbc)
        jei, jsh = ref.neighbors.radius_graph_pbc(pos, cell, 1.6, pbc=pbc)
        assert np.array_equal(ei, jei) and np.array_equal(sh, jsh)
        cases.append(("pbc", ei, sh, lambda pos=pos, pbc=pbc: port.neighbors.radius_graph_pbc(
            pos, cell, 1.6, pbc=pbc), lambda pos=pos, pbc=pbc: ref.neighbors.radius_graph_pbc(
            pos, cell, 1.6, pbc=pbc)))
    # a geometry too sparse for dense bins falls back to numpy on both
    far = np.array([[0.0, 0, 0], [1e5, 0, 0], [1e5 + 0.5, 0, 0]])
    assert np.array_equal(port.neighbors.radius_graph(far, 1.0),
                          ref.neighbors.radius_graph(far, 1.0))
    monkeypatch.setenv("HYDRAGNN_TPU_NO_NATIVE", "1")
    for kind, ei, sh, numpy_port, numpy_ref in cases:
        pei, psh = numpy_port()
        jei, jsh = numpy_ref()
        assert np.array_equal(pei, jei) and (psh is None or np.array_equal(psh, jsh))
        a, ash = _canon(ei, sh)
        b, bsh = _canon(pei, psh)
        assert np.array_equal(a, b), kind
        if sh is not None:
            np.testing.assert_allclose(ash, bsh, atol=1e-9)
    assert any(not np.array_equal(c[1], c[3]()[0]) for c in cases), "orders never differ"


# ------------------------------------------------------- the field map
def test_mixed_fields_batches_equal_reference(port, ref):
    """Eight samples, batch 2: ``edge_attr`` on samples 0-3 only
    materializes (zero-filled) in all four batches, as the JAX loader
    gives them, through the serial feed and the workers; ``forces`` on
    samples 0-3 only is refused."""
    fields = _fields(8, seed=2)
    for i, f in enumerate(fields):
        f["cell"] = None
        if i >= 4:
            f["edge_attr"] = None
    jb = list(ref.loader.GraphLoader(_make(ref.graph.GraphSample, fields), 2, shuffle=False))
    # the JAX loader gives these batches unplanned: edges in sample order
    tl = port.loader.GraphLoader(_make(port.graph.GraphSample, fields), 2, shuffle=False,
                                 with_segment_plan=False)
    tb = list(tl)
    assert len(tb) == len(jb) == 4
    for t, j in zip(tb, jb):
        assert t.edge_attr is not None
        for k in ("x", "senders", "receivers", "edge_mask", "edge_attr", "y_graph", "pos"):
            assert np.array_equal(np.asarray(getattr(t, k)), np.asarray(getattr(j, k))), k
    for packed in (True, False):
        feed = port.pipeline.ParallelPipelineLoader(tl, workers=2, depth=2, chunk=1,
                                                    packed=packed)
        for a, b in zip(feed, tb):
            _same_batch(a, b)
    for i, f in enumerate(fields):
        f["forces"] = np.zeros_like(f["pos"]) if i < 4 else None
    with pytest.raises(ValueError) as te:
        port.loader.GraphLoader(_make(port.graph.GraphSample, fields), 2)
    with pytest.raises(ValueError) as je:
        ref.loader.GraphLoader(_make(ref.graph.GraphSample, fields), 2)
    assert str(te.value) == str(je.value)
    assert "Partially-labeled dataset: forces present on 4/8 samples" in str(te.value)


# ------------------------------------------------------ lazy containers
class _Counting:
    """A container that counts the samples read from it."""

    def __init__(self, samples):
        self._samples = samples
        self.reads = 0

    def __len__(self):
        return len(self._samples)

    def __getitem__(self, i):
        self.reads += 1
        return self._samples[i]

    def sample_sizes(self):
        return (np.array([s.num_nodes for s in self._samples]),
                np.array([s.num_edges for s in self._samples]))

    def field_widths(self):
        return {"edge_attr": 1, "cell": None}

    def label_fields(self):
        return frozenset({"pos", "energy", "y_graph", "y_node"})


def test_lazy_containers_read_nothing_at_construction(port, tmp_path):
    g = port.graph
    samples = _make(g.GraphSample, _fields(24, seed=9))
    box = _Counting(samples)
    loaders = {}
    for mode, kw in (("fixed", {}), ("ladder", dict(fixed_pad="auto")),
                     ("packed", dict(packing=True))):
        loaders[mode] = port.loader.GraphLoader(box, 5, shuffle=True, seed=3, **kw)
        assert loaders[mode].dataset is box
    assert port.runtime.shard_dataset_for_process(box) is box
    port.padschedule.dataset_size_arrays(box)
    config = {"NeuralNetwork": {"Architecture": {"global_attn_engine": "GPS",
                                                 "num_nodes": 7, "output_heads": {}}}}
    port.runner._check_num_nodes_bound(config, box, box, box)
    config["NeuralNetwork"]["Architecture"]["num_nodes"] = 6
    with pytest.raises(ValueError, match="exceeds Architecture.num_nodes=6"):
        port.runner._check_num_nodes_bound(config, box)
    assert box.reads == 0
    for mode, ld in loaders.items():
        lists = port.loader.GraphLoader(samples, 5, shuffle=True, seed=3,
                                        **{"fixed": {}, "ladder": dict(fixed_pad="auto"),
                                           "packed": dict(packing=True)}[mode])
        for epoch in (0, 1):
            ld.set_epoch(epoch)
            lists.set_epoch(epoch)
            got, want = list(ld), list(lists)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                _same_batch(a, b)
    assert box.reads > 0
    # a BinDataset: header answers only, then the same batches as the list
    p = str(tmp_path / "lazy.hgb")
    port.binformat.write_bin_dataset(p, samples)
    ds = port.binformat.BinDataset(p)
    loads = []
    orig = port.binformat.BinDataset._load
    port.binformat.BinDataset._load = lambda self, i: loads.append(i) or orig(self, i)
    try:
        ld = port.loader.GraphLoader(ds, 5, shuffle=True, seed=3, packing=True)
        config["NeuralNetwork"]["Architecture"]["num_nodes"] = 7
        port.runner._check_num_nodes_bound(config, ds)
        assert port.runtime.shard_dataset_for_process(ds) is ds and loads == []
        got = list(port.pipeline.ParallelPipelineLoader(ld, workers=2, depth=2))
    finally:
        port.binformat.BinDataset._load = orig
    want = list(port.loader.GraphLoader(samples, 5, shuffle=True, seed=3, packing=True))
    for a, b in zip(got, want):
        _same_batch(a, b)
    assert len(got) == len(want) and len(loads) == len(samples)


# ---------------------------------------------------------- run_training
def _schnet_config(fmt, paths, epochs=3):
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": f"formats_{fmt}", "format": fmt, "path": paths},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "SchNet", "radius": 2.5, "num_gaussians": 8, "num_filters": 8,
                "hidden_dim": 8, "num_conv_layers": 2,
                "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 8,
                                           "num_headlayers": 1, "dim_headlayers": [8]}},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {"input_node_features": [0], "output_names": ["y"],
                                      "output_index": [0], "type": ["graph"],
                                      "output_dim": [1]},
            # the single scheme named: under "auto" the JAX package takes
            # dp over the 8 virtual CPU devices these tests pin
            "Training": {"num_epoch": epochs, "batch_size": 8,
                         "Optimizer": {"type": "AdamW", "learning_rate": 1e-2},
                         "Parallelism": {"scheme": "single"}},
        },
    }


def _molecules(port, n, seed):
    """tests/test_binformat.py's molecules (radius 2.5, 10 neighbours)."""
    rr = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rr.integers(4, 8))
        pos = rr.uniform(0, 3.0, (k, 3)).astype(np.float32)
        x = rr.normal(size=(k, 1)).astype(np.float32)
        out.append(port.graph.GraphSample(
            x=x, pos=pos, edge_index=port.neighbors.radius_graph(pos, 2.5, max_neighbours=10),
            y_graph=np.array([x.mean()], np.float32)))
    return out


def _assert_close(got, want, tol, name):
    scale = float(np.abs(want).max())
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * min(scale, 1.0), err_msg=name)


def _same_history(a, b):
    for name in ("train_loss", "val_loss", "test_loss"):
        assert getattr(a, name) == getattr(b, name), name


def _same_params(ma, mb):
    import torch

    sa, sb = ma.state_dict(), mb.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_run_training_binary_against_jax(port, monkeypatch, tmp_path):
    """The port's run on three ``.hgb`` files against the JAX package's run
    on the same files from the same initial parameters; then the port's
    run fed the same samples as lists, bit for bit."""
    import jax

    import hydragnn_tpu
    from hydragnn_tpu import runner as jrunner
    from hydragnn_tpu.models.create import init_params
    from hydragnn_tpu_torch.models import convert

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    splits = {}
    paths = {}
    for split, n, seed in (("train", 32, 1), ("validate", 8, 2), ("test", 8, 3)):
        splits[split] = _molecules(port, n, seed)
        paths[split] = str(tmp_path / f"{split}.hgb")
        port.binformat.write_bin_dataset(paths[split], splits[split])
    captured = {}

    def spy(model, example, seed=0):
        out = jax.jit(lambda b: init_params(model, b, seed=seed))(example)
        captured["params"] = jax.device_get(out[0])
        return out

    monkeypatch.setattr(jrunner, "init_params", spy)
    _, _, _, j_hist, _ = hydragnn_tpu.run_training(_schnet_config("binary", paths))
    sd = convert.params_from_jax(captured["params"])
    make = port.runner.create_model_config

    def with_jax_params(config, device=None, *, seed=0):
        model, cfg = make(config, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    monkeypatch.setattr(port.runner, "create_model_config", with_jax_params)
    state, model, cfg, t_hist, full = port.runner.run_training(
        _schnet_config("binary", paths), device="cpu")
    for name in ("train_loss", "val_loss", "test_loss"):
        _assert_close(np.asarray(getattr(t_hist, name)), np.asarray(getattr(j_hist, name)),
                      F32_TOL, name)
    assert t_hist.train_loss[-1] < t_hist.train_loss[0]
    _, model_l, _, l_hist, full_l = port.runner.run_training(
        _schnet_config("lists", {}), datasets=(splits["train"], splits["validate"],
                                               splits["test"]), device="cpu")
    _same_history(t_hist, l_hist)
    _same_params(model, model_l)
    # run_prediction on the containers equals the pass on the lists
    got = port.runner.run_prediction(full, state=state, model=model, cfg=cfg)
    want = port.runner.run_prediction(full_l, datasets=(splits["train"], splits["validate"],
                                                        splits["test"]),
                                      state=state, model=model, cfg=cfg)
    assert got[0] == want[0] and all(np.array_equal(a, b) for a, b in zip(got[3], want[3]))


@pytest.mark.parametrize("fmt", ["pickle", "XYZ", "CFG"])
def test_format_runs_equal_list_fed(port, monkeypatch, tmp_path, fmt):
    """The port's run_training on a pickle directory (and on XYZ and CFG
    files, read and processed as the raw path processes them) equals the
    same run fed the same samples as lists, bit for bit."""
    monkeypatch.chdir(tmp_path)
    if fmt == "pickle":
        splits = {s: _molecules(port, n, seed) for s, n, seed in
                  (("train", 24, 4), ("validate", 8, 5), ("test", 8, 6))}
        paths = {}
        for s, samples in splits.items():
            paths[s] = str(tmp_path / s)
            port.pickle.SimplePickleWriter(samples, paths[s])
        config = _schnet_config(fmt, paths, epochs=2)
        lists = tuple(splits[s] for s in ("train", "validate", "test"))
    else:
        _write_raw(tmp_path)
        sub = "xyz" if fmt == "XYZ" else "cfg"
        config = _schnet_config(fmt, {"total": str(tmp_path / sub)}, epochs=2)
        config["Dataset"]["node_features"] = {"column_index": [0]}
        config["NeuralNetwork"]["Training"]["batch_size"] = 2
        config["NeuralNetwork"]["Training"]["perc_train"] = 0.5
        if fmt == "CFG":
            config["NeuralNetwork"]["Architecture"]["periodic_boundary_conditions"] = True
        lists = port.runner._ingest_datasets(config)
        assert all(isinstance(x, list) and x for x in lists)
        if fmt == "CFG":
            assert all(s.cell is not None and s.edge_shifts is not None for s in lists[0])
    _, model_f, _, f_hist, _ = port.runner.run_training(config, device="cpu")
    _, model_l, _, l_hist, _ = port.runner.run_training(config, datasets=lists, device="cpu")
    assert np.isfinite(f_hist.train_loss).all()
    _same_history(f_hist, l_hist)
    _same_params(model_f, model_l)


def test_unknown_format_and_missing_sidecar(port, tmp_path):
    config = _schnet_config("netcdf", {"total": str(tmp_path)})
    with pytest.raises(ValueError, match="Unknown Dataset.format: netcdf"):
        port.runner._ingest_datasets(config)
    with pytest.raises(ValueError, match="train/validate/test"):
        port.runner._ingest_datasets(_schnet_config("binary", {"total": str(tmp_path)}))
    _write_raw(tmp_path)
    os.remove(tmp_path / "xyz" / "m2_energy.txt")
    with pytest.raises(ValueError, match="no graph target sidecar"):
        port.runner._ingest_datasets(_schnet_config("XYZ", {"total": str(tmp_path / "xyz")}))
