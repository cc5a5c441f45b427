"""The port's host side against the JAX package, bit for bit.

Covers: ``import hydragnn_tpu_torch`` stays free of JAX; the synthetic
request stream; ``collate`` with and without the block plan (at the
TPU's tiles and at the port's Hopper tiles); ``plan_sorted_blocks`` /
``plan_blocks_static``; ``fit_pack_budgets`` / ``pack_epoch_ffd``; and
the bins ``DynamicBatcher`` forms.
"""

import ast
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import padschedule as jpad
from hydragnn_tpu.ops import pallas_segment as jps
from hydragnn_tpu.serve import batcher as jbatcher
from hydragnn_tpu.serve import loadgen as jloadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hydragnn_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "hydragnn_tpu")


@pytest.fixture(scope="module")
def port():
    """torch and the port's host modules, imported when this file runs
    rather than at collection (test workers that never run it do not
    load torch)."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch.data import graph, padschedule
    from hydragnn_tpu_torch.ops import edge_pipeline
    from hydragnn_tpu_torch.serve import batcher, loadgen

    return types.SimpleNamespace(
        torch=torch, graph=graph, padschedule=padschedule,
        ep=edge_pipeline, batcher=batcher, loadgen=loadgen,
    )


def _tiles(port, which):
    """(be, bn): the TPU kernel's tiles or the port's Hopper defaults."""
    return (512, 256) if which == "tpu" else (port.ep.DEFAULT_BE, port.ep.DEFAULT_BN)


def _samples(port, n=12, seed=0, histogram="qm9"):
    return (
        jloadgen.synthetic_request_samples(histogram, n, seed=seed),
        port.loadgen.synthetic_request_samples(histogram, n, seed=seed),
    )


def test_import_pulls_in_no_jax():
    """A fresh interpreter importing the port (its serving, model and
    training modules, and the runner behind ``run_training``) loads no
    jax, flax, optax or hydragnn_tpu module."""
    code = (
        "import sys, hydragnn_tpu_torch\n"
        "import hydragnn_tpu_torch.serve.engine, hydragnn_tpu_torch.models.create\n"
        "import hydragnn_tpu_torch.serve, hydragnn_tpu_torch.serve.loadgen\n"
        "import hydragnn_tpu_torch.export, hydragnn_tpu_torch.utils.telemetry\n"
        "import hydragnn_tpu_torch.models.convert, hydragnn_tpu_torch.runner\n"
        "import hydragnn_tpu_torch.data.synthetic, hydragnn_tpu_torch.ops.neighbors\n"
        "assert callable(hydragnn_tpu_torch.run_training)\n"
        "assert callable(hydragnn_tpu_torch.run_prediction)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'hydragnn_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax():
    """No file of the port, nor chip_smoke.py, imports JAX or the JAX
    package (not even lazily inside a function)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    rel = {os.path.relpath(f, PORT) for f in files}
    # the training slice's modules are among those walked
    assert {
        "runner.py", "config/config.py", "data/loader.py", "data/raw.py",
        "data/synthetic.py", "ops/neighbors.py", "train/loop.py",
        "train/losses.py", "train/optimizer.py", "train/state.py",
        "utils/print_utils.py", "ops/e3.py", "ops/symmetric_contraction.py",
        "models/mace.py", "export.py", "serve/router.py", "serve/fleet.py",
        "serve/loadgen.py", "utils/telemetry.py",
    } <= rel
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in FORBIDDEN, f"{f} imports {mod}"


def test_request_stream_matches(port):
    js, ts = _samples(port, 24, seed=3, histogram="zinc_skew")
    for a, b in zip(js, ts):
        for f in ("x", "pos", "edge_index", "y_graph"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _assert_batches_equal(port, jb, tb):
    fields = tb.arrays()
    for name in (
        "x", "pos", "node_graph_idx", "node_slot", "node_mask", "senders",
        "receivers", "edge_mask", "graph_mask", "y_graph", "dataset_id",
        "seg_perm", "seg_ids", "seg_valid", "seg_window",
    ):
        jv = getattr(jb, name)
        if jv is None:
            assert name not in fields, name
            continue
        tv = fields[name]
        tv = tv.numpy() if isinstance(tv, port.torch.Tensor) else tv
        jv = np.asarray(jv)
        assert jv.dtype == tv.dtype, name
        np.testing.assert_array_equal(jv, tv, err_msg=name)


@pytest.mark.parametrize("with_plan", [False, True])
def test_collate_matches_tpu_tiles(port, with_plan):
    """The port's collate equals the JAX package's field by field (the
    JAX collate plans at the TPU's tiles, so the port is asked for those
    too)."""
    js, ts = _samples(port, 12, seed=1)
    pad = jgraph.PadSpec.for_samples(js)
    jb = jgraph.collate(js, pad, with_segment_plan=with_plan, as_numpy=True)
    tb = port.graph.collate(
        ts, port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs),
        with_segment_plan=with_plan, be=512, bn=256,
    )
    assert isinstance(tb.x, port.torch.Tensor)
    _assert_batches_equal(port, jb, tb)
    assert tb.seg_tile == ((512, 256) if with_plan else None)


def test_collate_plan_matches_at_hopper_tiles(port):
    """At the port's tiles, the attached plan equals the JAX planner run
    at those tiles over the same receiver-sorted edges."""
    js, ts = _samples(port, 16, seed=2)
    pad = jgraph.PadSpec.for_samples(js)
    jb = jgraph.collate(js, pad, with_segment_plan=True, as_numpy=True)
    tb = port.graph.collate(
        ts, port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs),
        with_segment_plan=True, as_numpy=True,
    )
    be, bn = _tiles(port, "hopper")
    np.testing.assert_array_equal(jb.receivers, tb.receivers)
    np.testing.assert_array_equal(jb.senders, tb.senders)
    want = jps.plan_blocks_static(
        jb.receivers, pad.num_nodes,
        jps.static_block_bound(pad.num_edges, pad.num_nodes, be, bn),
        be, bn, edge_valid=jb.edge_mask,
    )
    got = (tb.seg_perm, tb.seg_ids, tb.seg_valid, tb.seg_window)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("tiles", ["tpu", "hopper"])
@pytest.mark.parametrize("masked", [False, True])
def test_planner_matches(port, tiles, masked):
    """plan_sorted_blocks and plan_blocks_static (with static padding
    blocks) equal the JAX planner, including empty windows."""
    be, bn = _tiles(port, tiles)
    tep = port.ep
    rng = np.random.default_rng(be + bn + masked)
    n = 700
    # receivers leave gaps wider than a window: empty windows appear
    seg = np.sort(
        np.concatenate([rng.integers(0, 200, 900), rng.integers(500, 700, 600)])
    ).astype(np.int32)
    ev = rng.random(len(seg)) > 0.1 if masked else None
    for fn_j, fn_t, extra in (
        (jps.plan_sorted_blocks, tep.plan_sorted_blocks, ()),
        (jps.plan_blocks_static, tep.plan_blocks_static,
         (jps.static_block_bound(len(seg), n, be, bn) + 3,)),
    ):
        want = fn_j(seg, n, *extra, be=be, bn=bn, edge_valid=ev)
        got = fn_t(seg, n, *extra, be=be, bn=bn, edge_valid=ev)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)
    assert tep.static_block_bound(1500, n, be, bn) == jps.static_block_bound(
        1500, n, be, bn
    )
    empty_t = tep.plan_sorted_blocks(np.zeros(0, np.int32), 16, be, bn)
    empty_j = jps.plan_sorted_blocks(np.zeros(0, np.int32), 16, be, bn)
    for w, g in zip(empty_j, empty_t):
        np.testing.assert_array_equal(w, g)


def _spec_tuple(s):
    return (s.num_nodes, s.num_edges, s.num_graphs)


@pytest.mark.parametrize("slack", [None, 1.05])
def test_fit_pack_budgets_and_ffd_match(port, slack):
    tpad = port.padschedule
    rng = np.random.default_rng(7)
    nodes = rng.integers(4, 30, 120).astype(np.int64)
    edges = (nodes * 2 + rng.integers(0, 9, 120)).astype(np.int64)
    jb = jpad.fit_pack_budgets(nodes, edges, 8, slack=slack, seed=1)
    tb = tpad.fit_pack_budgets(nodes, edges, 8, slack=slack, seed=1)
    assert [_spec_tuple(s) for s in jb] == [_spec_tuple(s) for s in tb]
    order = rng.permutation(120)
    for window in (2, 256):
        jp = jpad.pack_epoch_ffd(order, nodes, edges, jb, window)
        tp = tpad.pack_epoch_ffd(order, nodes, edges, tb, window)
        assert len(jp) == len(tp)
        for (ji, js), (ti, ts) in zip(jp, tp):
            np.testing.assert_array_equal(ji, ti)
            assert _spec_tuple(js) == _spec_tuple(ts)


@pytest.mark.parametrize("max_open_bins", [2, 4])
def test_dynamic_batcher_bins_match(port, max_open_bins):
    """Fed the same requests, both batchers form the same bins (members,
    dispatch reasons and downshifted budgets)."""
    tpad, tbatcher = port.padschedule, port.batcher
    js, ts = _samples(port, 40, seed=4)
    ns = np.array([s.num_nodes for s in ts])
    es = np.array([s.num_edges for s in ts])
    budgets_j = jpad.fit_pack_budgets(ns, es, 8)
    budgets_t = tpad.fit_pack_budgets(ns, es, 8)

    def bins(mod, budgets, samples):
        bat = mod.DynamicBatcher(
            budgets, deadline_ms=1e6, max_open_bins=max_open_bins,
            clock=lambda: 0.0,
        )
        for s in samples:
            bat.submit(s)
        bat.close()
        out = []
        while True:
            item = bat.next_bin(timeout=0.0)
            if item is None:
                return out
            reason, b = item
            out.append((
                reason,
                [r.req_id for r in bat.bin_requests(b)],
                _spec_tuple(bat.bin_spec(b)),
            ))

    got = bins(tbatcher, budgets_t, ts)
    assert got == bins(jbatcher, budgets_j, js)
    assert {r for r, _, _ in got} >= {"flush"}
