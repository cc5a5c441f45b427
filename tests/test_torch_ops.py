"""The port's ops against the JAX package on the same inputs.

K1's plain version (``edge_pipeline_plain``, what the port runs on CPU
tensors) against the JAX ``edge_pipeline_planned`` in Pallas interpret
mode, as tests/test_pallas_segment.py runs it: every flavour in f32 and
bf16 on one plan with masked edges, empty windows and static padding
blocks, plus E=0. Then the rbf and segment ops, and the receiver
aggregation family on planned and unplanned batches.
"""

import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp

from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.ops import pallas_segment as jps
from hydragnn_tpu.ops import rbf as jrbf
from hydragnn_tpu.ops import segment as jseg
from hydragnn_tpu.serve import loadgen as jloadgen

# tests/test_pallas_segment.py:341-342
F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_TOL = dict(rtol=4e-2, atol=2.5e-1)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module")
def port():
    """torch and the port's ops, imported when this file runs rather
    than at collection (test workers that never run it do not load
    torch)."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch.data import graph
    from hydragnn_tpu_torch.ops import edge_pipeline, rbf, segment

    return types.SimpleNamespace(
        torch=torch, graph=graph, ep=edge_pipeline, rbf=rbf, seg=segment
    )


@pytest.fixture(scope="module")
def k1_case(port):
    """One plan at the port's Hopper tiles over 240 receiver-sorted
    edges: receivers skip nodes 32..63 (an empty window), about a tenth
    of the edges are masked out, and the plan carries static padding
    blocks."""
    rng = np.random.default_rng(11)
    n, e, f_in, f_out = 100, 240, 16, 24
    be, bn = port.ep.DEFAULT_BE, port.ep.DEFAULT_BN
    rcv = np.concatenate([rng.integers(0, 32, 120), rng.integers(64, n, 120)])
    seg = np.sort(rcv).astype(np.int32)
    ev = rng.random(e) > 0.1
    n_static = jps.static_block_bound(e, n, be, bn) + 2
    plan = jps.plan_blocks_static(seg, n, n_static, be, bn, edge_valid=ev)
    assert not plan[2][-be:].any()  # static padding block present
    assert 1 in plan[3] and not plan[2][plan[3].repeat(be) == 1].any()
    ops = {
        "a": rng.normal(size=(e, f_in)).astype(np.float32),
        "b": rng.normal(size=(e, f_in)).astype(np.float32),
        "w": (rng.normal(size=(f_in, f_out)) / 4).astype(np.float32),
    }
    return n, be, bn, plan, ops


def _run_jax(ops, plan, n, be, bn, stages, dt):
    a = jnp.asarray(ops["a"], JDT[dt])
    b = jnp.asarray(ops["b"], JDT[dt]) if "b" in stages else None
    w = jnp.asarray(ops["w"], JDT[dt]) if "w" in stages else None
    out = jps.edge_pipeline_planned(
        a, b, w, *(jnp.asarray(p) for p in plan), n, bn, be
    )
    return np.asarray(out.astype(jnp.float32))


def _run_port(port, ops, plan, n, be, bn, stages, dt):
    torch = port.torch
    dtype = getattr(torch, dt)
    a = torch.from_numpy(ops["a"]).to(dtype)
    b = torch.from_numpy(ops["b"]).to(dtype) if "b" in stages else None
    w = torch.from_numpy(ops["w"]).to(dtype) if "w" in stages else None
    out = port.ep.edge_pipeline_planned(
        a, b, w, *(torch.from_numpy(p) for p in plan), n, bn, be
    )
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("stages", ["a", "ab", "abw"])
def test_k1_plain_matches_pallas(port, k1_case, stages, dt):
    n, be, bn, plan, ops = k1_case
    want = _run_jax(ops, plan, n, be, bn, stages, dt)
    got = _run_port(port, ops, plan, n, be, bn, stages, dt)
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, **(F32_TOL if dt == "float32" else BF16_TOL)
    )
    # masked and padding slots contribute nothing; the empty window is 0
    assert not got[32:64].any()


def test_k1_plain_matches_pallas_at_tpu_tiles(port, k1_case):
    """The same function on a plan at the TPU's tiles (be=512, bn=256)."""
    n, _, _, _, ops = k1_case
    seg = np.sort(np.random.default_rng(5).integers(0, n, 240)).astype(np.int32)
    plan = jps.plan_blocks_static(seg, n, jps.static_block_bound(240, n))
    want = _run_jax(ops, plan, n, 512, 256, "abw", "float32")
    got = _run_port(port, ops, plan, n, 512, 256, "abw", "float32")
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("stages", ["a", "abw"])
def test_k1_empty_edges(port, k1_case, stages):
    """E=0 returns zeros of the output dtype, as the JAX wrapper does."""
    n, be, bn, plan, ops = k1_case
    empty = {k: (v[:0] if k != "w" else v) for k, v in ops.items()}
    for dt in ("float32", "bfloat16"):
        want = _run_jax(empty, plan, n, be, bn, stages, dt)
        got = _run_port(port, empty, plan, n, be, bn, stages, dt)
        np.testing.assert_array_equal(got, want)


@jax.jit
def _jax_rbf(pos, snd, rcv, shifts, d):
    """The JAX references of test_rbf_ops_match, compiled once."""
    return (
        *jrbf.edge_vectors_and_lengths(pos, snd, rcv, shifts),
        *jrbf.edge_vectors_and_lengths(
            pos, snd, rcv, shifts, normalize=True, eps=1.0
        ),
        jrbf.gaussian_smearing(d, 0.0, 4.0, 50),
        jrbf.cosine_cutoff(d, 4.0),
    )


def test_rbf_ops_match(port):
    torch, trbf = port.torch, port.rbf
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 4, size=(30, 3)).astype(np.float32)
    snd = rng.integers(0, 30, 80).astype(np.int32)
    rcv = rng.integers(0, 30, 80).astype(np.int32)
    shifts = rng.normal(size=(80, 3)).astype(np.float32)
    d = np.concatenate([np.linspace(0, 5, 41), [3.999, 4.0, 4.001]]).astype(np.float32)
    want = _jax_rbf(pos, snd, rcv, shifts, d)
    tp, ts, tr, tsh, td = (torch.from_numpy(v) for v in (pos, snd, rcv, shifts, d))
    got = (
        *trbf.edge_vectors_and_lengths(tp, ts, tr, tsh),
        *trbf.edge_vectors_and_lengths(tp, ts, tr, tsh, normalize=True, eps=1.0),
        trbf.gaussian_smearing(td, 0.0, 4.0, 50),
        trbf.cosine_cutoff(td, 4.0),
    )
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


@jax.jit
def _jax_segment_ops(data, ids, mask):
    """segment_sum, segment_mean, segment_max and degree over 10
    segments, without and with the mask, compiled once."""
    out = []
    for m in (None, mask):
        out += [
            jseg.segment_sum(data, ids, 10, m),
            jseg.segment_mean(data, ids, 10, m),
            jseg.segment_max(data, ids, 10, m),
            jseg.degree(ids, 10, m),
        ]
    return out


def test_segment_ops_match(port):
    torch, tseg = port.torch, port.seg
    rng = np.random.default_rng(1)
    data = rng.normal(size=(60, 5)).astype(np.float32)
    ids = rng.integers(0, 9, 60).astype(np.int32)  # segment 9 stays empty
    mask = rng.random(60) > 0.2
    want = iter(_jax_segment_ops(data, ids, mask))
    td, ti, tm = (torch.from_numpy(v) for v in (data, ids, mask))
    for m in (None, tm):
        j_sum, j_mean, j_max, j_deg = (np.asarray(next(want)) for _ in range(4))
        for w, g in (
            (j_sum, tseg.segment_sum(td, ti, 10, m)),
            (j_sum, tseg.dense_segment_sum(td, ti, 10, m)),
            (j_mean, tseg.segment_mean(td, ti, 10, m)),
            (j_mean, tseg.segment_mean(td, ti, 10, m, dense=True)),
            (j_max, tseg.segment_max(td, ti, 10, m)),
            (j_deg, tseg.degree(ti, 10, m)),
        ):
            np.testing.assert_allclose(g.numpy(), w, **F32_TOL)


AGG_OPS = ["sum", "mean", "product", "pipeline", "pipeline_mean"]


def _aggregate(seg, a, b, w, batch, op, **kw):
    """One receiver aggregation ``op`` through module ``seg`` (the JAX
    package's or the port's ops/segment.py)."""
    if op == "sum":
        return seg.aggregate_receivers(a, batch, **kw)
    if op == "mean":
        return seg.aggregate_receivers_mean(a, batch, **kw)
    if op == "product":
        return seg.aggregate_receivers_product(a, b, batch, **kw)
    return seg.aggregate_receivers_pipeline(
        a, b, batch, weight=w, mean=op == "pipeline_mean", **kw
    )


@pytest.fixture(scope="module")
def agg_case(port):
    """One set of requests collated without a plan (JAX and port) and
    with the port's plan. Edge operands are functions of the endpoints,
    so they agree across the two edge orders; the JAX (XLA scatter)
    references of every op are computed in one compiled call."""
    samples = jloadgen.synthetic_request_samples("qm9", 10, seed=5)
    pad = jgraph.PadSpec.for_samples(samples)
    tpad = port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs)
    jb = jgraph.collate(samples, pad)
    rng = np.random.default_rng(6)
    h1, h2 = (rng.normal(size=(pad.num_nodes, 8)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(8, 12)).astype(np.float32)

    @jax.jit
    def refs(h1, h2, w):
        a, b = h1[jb.senders], h2[jb.receivers]
        return [_aggregate(jseg, a, b, w, jb, op, use_plan=False) for op in AGG_OPS]

    want = dict(zip(AGG_OPS, (np.asarray(r) for r in refs(h1, h2, w))))
    batches = {
        False: port.graph.collate(samples, tpad),
        True: port.graph.collate(samples, tpad, with_segment_plan=True),
    }
    return want, batches, h1, h2, w


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("op", AGG_OPS)
def test_aggregate_receivers_match(port, agg_case, op, planned):
    torch = port.torch
    want, batches, h1, h2, w = agg_case
    tb = batches[planned]
    a = torch.from_numpy(h1)[tb.senders.long()]
    b = torch.from_numpy(h2)[tb.receivers.long()]
    got = _aggregate(port.seg, a, b, torch.from_numpy(w), tb, op)
    np.testing.assert_allclose(got.numpy(), want[op], **F32_TOL)
