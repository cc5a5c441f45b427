"""The PNAPlus + GPS slice against the JAX package, on the CPU.

Small models (2 layers, hidden 16, 2 heads, pe_dim 4, num_radial 5) on a
few ZINC-like bond graphs made here from a seeded numpy generator (the
examples/zinc/zinc.py recipe at 5-11 atoms), collated by both packages
from the same arrays. Parameters and the ``batch_stats`` collection are
the JAX package's, carried over with ``params_from_jax``. On a planned
batch the JAX side is forced onto its Pallas kernel (interpreted) with
HYDRAGNN_TPU_SEGMENT_IMPL=pallas (the reduce-only ``aggregate_receivers``
of PNA's moment pass; its pullback stays XLA's); the port runs K1's and
K2's plain versions at the Hopper tiles. A batch without a plan runs the
XLA scatter against ``index_add_``.

- ``laplacian_pe``/``relative_pe`` bit for bit;
- ``to_dense_batch``/``from_dense_batch`` with a slot past ``max_nodes``;
- ``segment_min`` and ``segment_multi_aggregate``, forward and gradient,
  scatter and planned, with masked edges, an empty segment and ties;
- ``MaskedBatchNorm`` in train and eval mode, and its running
  statistics after two steps, in f32 and bf16;
- the PNAPlus + GPS forward (train mode and its updated running
  statistics) for the ``multihead`` engine, scatter and planned, and the
  ``performer`` engine, planned; plain PNA with ``edge_attr``;
- one train step (loss, gradients, AdamW-updated parameters, running
  statistics) on the planned batch in f32 and bf16, then the eval-mode
  forward from the step's statistics;
- the ``packing: "auto"`` decision and budgets, ``update_config``, and
  the packed epoch plans and batches, bit for bit;
- (``slow``) two epochs of ``run_training`` with packing ``"auto"``:
  the per-epoch losses equal JAX's.

Tolerances (ROADMAP "How parity is judged"): f32 forward rtol 1e-5 /
atol 1e-4, f32 gradients and updated parameters rtol 1e-4 / atol 1e-3,
bf16 rtol 4e-2 / atol 2.5e-1, each atol scaled by the reference's
largest magnitude where that is below 1 (tests/test_torch_slice.py).
A train step's gradients and updated parameters are held with the atol
scaled by the largest gradient or parameter over all parameters, not by
each tensor's own: a bias in front of a batch norm has a true gradient
of zero, and both packages return rounding noise there.
"""

import copy
import os
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import hydragnn_tpu
from hydragnn_tpu import runner as jrunner
from hydragnn_tpu.config import update_config as jupdate_config
from hydragnn_tpu.config.config import gather_deg
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import loader as jloader
from hydragnn_tpu.data import padschedule as jpads
from hydragnn_tpu.models import layers as jlayers
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.models.create import init_params
from hydragnn_tpu.ops import dense as jdense
from hydragnn_tpu.ops import pe as jpe
from hydragnn_tpu.ops import segment as jsegment
from hydragnn_tpu.train.losses import multihead_loss
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import cast_batch, create_train_state

HERE = os.path.dirname(os.path.abspath(__file__))
ZINC = os.path.join(HERE, "..", "examples", "zinc")
F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=4e-2, atol=2.5e-1)
TRAINING = {"Optimizer": {"type": "AdamW", "learning_rate": 2e-3}}
PE_DIM = 4
MAX_NODES = 12
ATTN = ("multihead", "performer")


def _assert_close(got, want, tol, name="", scale=None):
    """``got`` equals ``want`` at ``tol``'s rtol and its atol times
    min(scale, 1), ``scale`` being ``want``'s largest magnitude unless
    given; an all-zero reference needs an all-zero result."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 0.0
    if not np.abs(want).any():
        assert not np.abs(got).any(), name
        return
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0), err_msg=name
    )


@pytest.fixture(scope="module")
def port():
    """torch and the port's modules, imported when this file runs rather
    than at collection."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import config, runner
    from hydragnn_tpu_torch.data import graph, loader, padschedule
    from hydragnn_tpu_torch.models import convert, create, layers, spec
    from hydragnn_tpu_torch.ops import dense, edge_pipeline, pe, segment
    from hydragnn_tpu_torch.train import loop, optimizer

    return types.SimpleNamespace(
        torch=torch, config=config, runner=runner, graph=graph, loader=loader,
        padschedule=padschedule, convert=convert, create=create, layers=layers,
        spec=spec, dense=dense, ep=edge_pipeline, pe=pe, segment=segment, loop=loop,
        optimizer=optimizer,
    )


def _molecules(n, seed, n_lo=5, n_hi=12, edge_dim=0):
    """ZINC-like bond graphs (examples/zinc/zinc.py's recipe: a random
    tree plus ring closures over organic atom types, a structural
    target, random layout positions) with the JAX package's Laplacian
    and relative PE; ``edge_dim`` adds random edge features."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(n_lo, n_hi))
        z = rng.choice([6, 7, 8, 9, 16], k, p=[0.6, 0.12, 0.16, 0.06, 0.06])
        edges = [(i, int(rng.integers(0, i))) for i in range(1, k)]
        for _ in range(int(rng.integers(0, 3))):
            a, b = rng.integers(0, k, 2)
            if a != b:
                edges.append((int(a), int(b)))
        snd = [e[0] for e in edges] + [e[1] for e in edges]
        rcv = [e[1] for e in edges] + [e[0] for e in edges]
        ei = np.array([snd, rcv], dtype=np.int64)
        pe = jpe.laplacian_pe(ei, k, PE_DIM)
        kw = {}
        if edge_dim:
            kw["edge_attr"] = rng.normal(size=(ei.shape[1], edge_dim)).astype(np.float32)
        out.append(jgraph.GraphSample(
            x=z.reshape(-1, 1).astype(np.float32),
            pos=rng.uniform(0, k ** (1 / 3), (k, 3)).astype(np.float32),
            edge_index=ei, pe=pe, rel_pe=jpe.relative_pe(ei, pe),
            y_graph=np.array([z.mean() / 10.0 - 0.1 * len(edges) / k], np.float32),
            **kw,
        ))
    return out


def _to_port(port, samples):
    """The port's GraphSamples holding the same numpy arrays."""
    fields = ("x", "pos", "edge_index", "pe", "rel_pe", "y_graph", "edge_attr")
    return [port.graph.GraphSample(**{f: getattr(s, f) for f in fields}) for s in samples]


def _cfg(spec, mpnn_type="PNAPlus", attn="multihead", *, deg, gps=True, edge_dim=None):
    """zinc.json's PNAPlus + GPS cut to the test widths, built from either
    package's spec module."""
    kw = dict(global_attn_engine="GPS", global_attn_type=attn, global_attn_heads=2,
              pe_dim=PE_DIM) if gps else {}
    return spec.ModelConfig(
        mpnn_type=mpnn_type, input_dim=1, hidden_dim=16, num_conv_layers=2,
        heads=(spec.HeadSpec("y", "graph", 1),),
        graph_branches=(spec.BranchSpec(num_sharedlayers=2, dim_sharedlayers=16,
                                        num_headlayers=2, dim_headlayers=(16, 16)),),
        task_weights=(1.0,), radius=5.0, num_radial=5, envelope_exponent=5,
        pna_deg=tuple(int(d) for d in deg), max_neighbours=len(deg) - 1,
        num_nodes=MAX_NODES, edge_dim=edge_dim, **kw,
    )


def _pad(port, pad):
    return port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs)


@pytest.fixture(scope="module")
def data(port):
    """Six molecules collated by both packages without and with the plan
    (``jbs``/``tbs`` keyed by planned), and the degree histogram."""
    js = _molecules(6, seed=0)
    ts = _to_port(port, js)
    pad = jgraph.PadSpec.for_samples(js)
    jbs, tbs = {}, {}
    for planned in (False, True):
        jbs[planned] = jgraph.collate(js, pad, with_segment_plan=planned)
        tbs[planned] = port.graph.collate(ts, _pad(port, pad), with_segment_plan=planned)
        assert (tbs[planned].seg_window is not None) == planned
        np.testing.assert_array_equal(np.asarray(jbs[planned].node_slot),
                                      tbs[planned].node_slot.numpy())
    return js, ts, jbs, tbs, gather_deg(js)


def _port_model(port, tcfg, params, batch_stats):
    model = port.create.create_model(tcfg, "cpu")
    model.load_state_dict(port.convert.params_from_jax(params, batch_stats))
    return model


def test_positional_encodings_match_jax(port):
    """Laplacian PE (with a graph smaller than pe_dim + 1 and an isolated
    node) and relative PE, bit for bit."""
    graphs = [(np.array([[0, 1], [1, 0]]), 2), (np.array([[0, 1, 2], [1, 2, 0]]), 5)]
    graphs += [(s.edge_index, s.num_nodes) for s in _molecules(4, seed=3)]
    for ei, n in graphs:
        want = jpe.laplacian_pe(ei, n, PE_DIM)
        got = port.pe.laplacian_pe(ei, n, PE_DIM)
        assert got.dtype == want.dtype and got.shape == (n, PE_DIM)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port.pe.relative_pe(ei, got), jpe.relative_pe(ei, want))
    empty = np.zeros((2, 0), np.int64)
    np.testing.assert_array_equal(port.pe.relative_pe(empty, want),
                                  jpe.relative_pe(empty, want))


def _extreme_inputs(jb, width=3, seed=4):
    """Edge features with deliberate ties: three edges copy the features
    of an earlier edge into the same receiver, with values below every
    other edge's there, so each pair is that receiver's minimum. Returns
    the features and the tied (earlier, later) edge pairs."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(jb.num_edges, width)).astype(np.float32)
    rcv, mask = np.asarray(jb.receivers), np.asarray(jb.edge_mask)
    pairs = []
    for e in range(1, int(mask.sum())):
        first = np.nonzero((rcv[:e] == rcv[e]) & mask[:e])[0]
        if len(first) and len(pairs) < 3 and rcv[e] not in [rcv[a] for a, _ in pairs]:
            h[first[0]] = h[e] = -10.0 - len(pairs)
            pairs.append((int(first[0]), e))
    assert len(pairs) == 3
    return h, pairs


DENSE_MAX = 7  # below the largest test graph, so to_dense_batch drops nodes
BN_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _bn_inputs():
    rng = np.random.default_rng(7)
    xs = [rng.normal(2.0, 3.0, size=(10, 5)).astype(np.float32) for _ in range(2)]
    params = {"scale": np.linspace(0.5, 1.5, 5, dtype=np.float32),
              "bias": np.linspace(-1, 1, 5, dtype=np.float32)}
    return xs, np.arange(10) < 7, params


@pytest.fixture(scope="module")
def op_reference(data):
    """The JAX side of the op tests in one compiled call (at XLA's lowest
    backend optimisation: it runs once): to_dense_batch/from_dense_batch
    and segment_min with their gradients on the scatter batch,
    segment_multi_aggregate and its gradient on both batches in f32 and
    bf16 (the planned batch through the interpreted Pallas kernel), and
    MaskedBatchNorm's two train steps and eval step in f32 and bf16."""
    _, _, jbs, _, _ = data
    jb = jbs[False]
    n = jb.num_nodes
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(jb.num_graphs, DENSE_MAX, 3)).astype(np.float32)
    h_min, pairs = _extreme_inputs(jb)
    cot_min = rng.normal(size=(n, 3)).astype(np.float32)
    h_multi, _ = _extreme_inputs(jb, width=4)
    cot_multi = rng.normal(size=(n, 16)).astype(np.float32)
    xs, mask, bn_params = _bn_inputs()
    bn = jlayers.MaskedBatchNorm()
    bn_stats0 = {"mean": np.zeros(5, np.float32), "var": np.ones(5, np.float32)}

    def dense(xx):
        d, m = jdense.to_dense_batch(xx, jb, DENSE_MAX)
        back = jdense.from_dense_batch(d * w, jb, DENSE_MAX)
        return jnp.sum(back * back), (d, m, back)

    def seg_min(hh):
        out = jsegment.segment_min(hh, jb.receivers, n, mask=jb.edge_mask)
        return jnp.sum(out * cot_min), out

    def multi(hh, batch, dt):
        parts = jsegment.segment_multi_aggregate(hh.astype(dt), batch)
        out = jnp.concatenate(parts, axis=-1).astype(jnp.float32)
        return jnp.sum(out * cot_multi), out

    def batch_norm(dt):
        stats, outs = bn_stats0, []
        for xx in xs:
            out, mut = bn.apply({"params": bn_params, "batch_stats": stats},
                                jnp.asarray(xx, dt), mask, train=True,
                                mutable=["batch_stats"])
            stats = mut["batch_stats"]
            outs.append(out)
        outs.append(bn.apply({"params": bn_params, "batch_stats": stats},
                             jnp.asarray(xs[1], dt), mask, train=False))
        return outs, stats

    def run(batches):
        vg = jax.value_and_grad
        return {
            "dense": vg(dense, has_aux=True)(jnp.asarray(x)),
            "min": vg(seg_min, has_aux=True)(jnp.asarray(h_min)),
            "multi": {(planned, name): vg(multi, has_aux=True)(
                jnp.asarray(h_multi), batches[planned], dt)
                for planned in (False, True) for name, dt in BN_DTYPES.items()},
            "bn": {name: batch_norm(dt) for name, dt in BN_DTYPES.items()},
        }

    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRAGNN_TPU_SEGMENT_IMPL", "pallas")  # read while tracing
    try:
        out = jax.device_get(jax.jit(run).lower(jbs).compile(
            {"xla_backend_optimization_level": 0})(jbs))
    finally:
        mp.undo()
    inputs = dict(x=x, w=w, h_min=h_min, pairs=pairs, cot_min=cot_min,
                  h_multi=h_multi, cot_multi=cot_multi)
    return inputs, out


def test_dense_batch_matches_jax(port, data, op_reference):
    """to_dense_batch and from_dense_batch, forward and gradient, with a
    bound below the largest graph (its extra nodes are dropped) and the
    padding nodes written to the padding graph's slots."""
    torch = port.torch
    _, _, jbs, tbs, _ = data
    inputs, out = op_reference
    (_, (j_dense, j_mask, j_back)), j_grad = out["dense"]
    tb = tbs[False]
    slot, real = tb.node_slot.numpy(), tb.node_mask.numpy()
    assert slot[real].max() >= DENSE_MAX and not real.all()
    tx = torch.from_numpy(inputs["x"]).requires_grad_(True)
    dense, mask = port.dense.to_dense_batch(tx, tb, DENSE_MAX)
    back = port.dense.from_dense_batch(dense * torch.from_numpy(inputs["w"]), tb, DENSE_MAX)
    (back * back).sum().backward()
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_array_equal(dense.detach().numpy(), j_dense)
    np.testing.assert_array_equal(back.detach().numpy(), j_back)
    _assert_close(tx.grad.numpy(), j_grad, GRAD_TOL, "grad")
    dropped = real & (slot >= DENSE_MAX)
    assert dropped.any() and not tx.grad.numpy()[dropped].any()


def test_segment_min_matches_jax(port, data, op_reference):
    """segment_min over masked edges, with ties and empty segments: the
    values and the gradient (tied minima share it equally)."""
    _, _, _, tbs, _ = data
    inputs, out = op_reference
    (_, j_out), j_grad = out["min"]
    tb = tbs[False]
    n = tb.num_nodes
    empty = np.ones(n, bool)
    empty[tb.receivers.numpy()[tb.edge_mask.numpy()]] = False
    assert empty.any()  # the padding node
    cot = inputs["cot_min"]
    th = port.torch.from_numpy(inputs["h_min"]).requires_grad_(True)
    got = port.segment.segment_min(th, tb.receivers, n, mask=tb.edge_mask)
    (got * port.torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), j_out)
    assert not got.detach().numpy()[empty].any()
    np.testing.assert_allclose(th.grad.numpy(), j_grad, rtol=1e-6, atol=0)
    rcv = tb.receivers.numpy()
    for a, b in inputs["pairs"]:  # each tied minimum takes half the cotangent
        np.testing.assert_allclose(th.grad.numpy()[[a, b]], 0.5 * cot[[rcv[a]] * 2],
                                   rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("planned", [False, True])
def test_segment_multi_aggregate_matches_jax(port, data, op_reference, planned, dtype):
    """(mean, min, max, std) and the gradient through all four: masked
    edges, the empty padding segment, ties, and receivers with one edge
    (var = 0, where the clamp's gradient splits in half).

    In bf16 the gradient at an edge into a one-edge receiver is the
    difference of two terms of size T = |h| |d std| / std (2 h d_sq and
    2 mean d_sq, with std = sqrt(eps) there: ~400 here), which cancel
    exactly in exact arithmetic; each package rounds them to bf16 in its
    own order, so there the bound adds 2^-6 T (four roundings of 2^-8
    relative error) to the bf16 tolerance."""
    torch = port.torch
    _, _, _, tbs, _ = data
    inputs, out = op_reference
    (_, j_out), j_grad = out["multi"][(planned, dtype)]
    h, cot = inputs["h_multi"], inputs["cot_multi"]
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    th = torch.from_numpy(h).requires_grad_(True)
    got = torch.cat(port.segment.segment_multi_aggregate(th.to(dt), tbs[planned]), -1).float()
    (got * torch.from_numpy(cot)).sum().backward()
    if dtype == "f32":
        _assert_close(got.detach().numpy(), j_out, F32_TOL, "aggregates")
        _assert_close(th.grad.numpy(), j_grad, GRAD_TOL, "grad")
        return
    _assert_close(got.detach().numpy(), j_out, BF16_TOL, "aggregates")
    f = h.shape[1]
    tb = tbs[planned]
    rcv, valid = tb.receivers.numpy(), tb.edge_mask.numpy()
    terms = np.abs(h) * np.abs(cot[rcv, 3 * f:]) / np.asarray(j_out)[rcv, 3 * f:]
    want_g = np.asarray(j_grad, np.float64)
    bound = (BF16_TOL["atol"] * min(float(np.abs(want_g).max()), 1.0)
             + BF16_TOL["rtol"] * np.abs(want_g) + 2.0**-6 * terms * valid[:, None])
    err = np.abs(th.grad.numpy() - want_g)
    assert (err <= bound).all(), (err - bound).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_masked_batch_norm_matches_jax(port, op_reference, dtype):
    """Two train steps (outputs and running statistics, which stay f32),
    then eval mode from those statistics."""
    torch = port.torch
    j_outs, j_stats = op_reference[1]["bn"][dtype]
    xs, mask, params = _bn_inputs()
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    bn = port.layers.MaskedBatchNorm(5)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}
                       | {"mean": torch.zeros(5), "var": torch.ones(5)})
    bn.train()
    for x, want in zip(xs, j_outs):
        got = bn(torch.from_numpy(x).to(tdt), torch.from_numpy(mask))
        # f32 scale and bias promote a bf16 input's result to f32 in both
        assert got.dtype == torch.float32 and want.dtype == np.float32
        _assert_close(got.detach().numpy(), want, tol, "train")
    assert bn.mean.dtype == bn.var.dtype == torch.float32
    _assert_close(bn.mean.numpy(), j_stats["mean"], tol, "running mean")
    _assert_close(bn.var.numpy(), j_stats["var"], tol, "running var")
    bn.eval()
    got = bn(torch.from_numpy(xs[1]).to(tdt), torch.from_numpy(mask))
    _assert_close(got.detach().numpy(), j_outs[2], tol, "eval")


def _jax_trees(model):
    """A port model's parameters and running statistics as the JAX
    package's ``params`` and ``batch_stats`` trees (the inverse of
    ``params_from_jax``: Linear weights transposed into Dense kernels)."""
    params, stats = {}, {}
    for key, t in model.state_dict().items():
        *mods, leaf = key.split(".")
        arr = t.detach().numpy().copy()
        if leaf in ("mean", "var"):
            tree = stats
        elif leaf == "weight":
            tree, leaf, arr = params, "kernel", arr.T.copy()
        else:
            tree = params
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr
    return params, stats


STEP_CASES = [("f32", True), ("bf16", True)]


@pytest.fixture(scope="module")
def model_reference(port, data):
    """The port's PNAPlus + GPS initial parameters (flax's initializers,
    seed 0) as JAX trees, and in one compiled call at XLA's lowest
    backend optimisation: make_train_step's body written out (value and
    gradients of the train-mode loss with the updated batch_stats, then
    AdamW's apply_gradients) for each STEP_CASES case on the planned
    batch, then eval-mode outputs from the initial parameters and the
    step's statistics; and the
    train-mode outputs of the multihead engine on the scatter batch and
    of the performer engine on the planned batch."""
    _, _, jbs, _, deg = data
    params, stats = _jax_trees(port.create.create_model(_cfg(port.spec, deg=deg), "cpu"))
    models = {attn: jcreate_model(_cfg(jspec, attn=attn, deg=deg)) for attn in ATTN}
    jcfg = _cfg(jspec, deg=deg)
    tx = jselect_optimizer(TRAINING)
    dts = {"f32": jnp.float32, "bf16": jnp.bfloat16}

    def train_fwd(model, p, batch):
        outputs, mut = model.apply({"params": p, "batch_stats": stats}, batch, train=True,
                                   mutable=["batch_stats"])
        return outputs, mut["batch_stats"]

    def loss(p, batch):
        outputs, new_bn = train_fwd(models["multihead"], p, batch)
        tot, _ = multihead_loss(outputs, batch, jcfg)
        return tot, (outputs, new_bn)

    def run(params, batches):
        out = {}
        flat, unravel = ravel_pytree(params)
        for name, planned in STEP_CASES:
            cast = cast_batch(batches[planned], dts[name])
            (tot, (outputs, new_bn)), grads = jax.value_and_grad(loss, has_aux=True)(
                params, cast)
            # optax's AdamW is elementwise: applied to the raveled tree it
            # gives the same update and traces one leaf instead of ~100
            new = create_train_state(flat, tx).apply_gradients(ravel_pytree(grads)[0], tx)
            out[(name, planned)] = (outputs, new_bn, tot, grads, unravel(new.params))
        out[("f32", False)] = train_fwd(models["multihead"], params, batches[False])
        out[("performer", True)] = train_fwd(models["performer"], params, batches[True])
        for name, planned in STEP_CASES:  # eval mode from each step's statistics
            v = {"params": params, "batch_stats": out[(name, planned)][1]}
            out[("eval", name)] = models["multihead"].apply(
                v, cast_batch(batches[planned], dts[name]), train=False)
        return out

    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRAGNN_TPU_SEGMENT_IMPL", "pallas")  # read while tracing
    try:
        compiled = jax.jit(run).lower(params, jbs).compile(
            {"xla_backend_optimization_level": 0})
        return params, stats, jax.device_get(compiled(params, jbs))
    finally:
        mp.undo()


def _check_stats(port, model, j_stats, tol):
    """The model's running statistics against JAX's, at ``tol`` without
    scaling: a norm after another norm sees a batch mean that is zero
    up to rounding (~1e-9), so its running mean has no scale of its
    own."""
    got = model.state_dict()
    paths = port.convert.params_from_jax({}, j_stats)
    assert set(paths) == {k for k in got if k.endswith((".mean", ".var"))}
    for path, arr in paths.items():
        _assert_close(got[path].numpy(), arr.numpy(), tol, path, scale=1.0)


@pytest.mark.parametrize("attn,planned", [("multihead", False), ("multihead", True),
                                           ("performer", True)])
def test_pnaplus_gps_forward_matches_flax(port, data, model_reference, attn, planned):
    """Graph outputs in train mode and the running statistics they leave
    (eval mode is held after the train step)."""
    _, _, _, tbs, deg = data
    params, stats, want = model_reference
    key = ("f32", planned) if attn == "multihead" else ("performer", planned)
    j_out, j_stats = want[key][:2]
    model = _port_model(port, _cfg(port.spec, attn=attn, deg=deg), params, stats)
    model.train()
    with port.torch.no_grad():
        got = model(tbs[planned])[0]
    real = tbs[planned].graph_mask.numpy()
    _assert_close(got.numpy()[real], np.asarray(j_out[0])[real], F32_TOL, "train out")
    _check_stats(port, model, j_stats, F32_TOL)


def test_plain_pna_with_edge_attr_matches_flax(port):
    """Plain PNA (no GPS, no radial basis) with edge features through its
    edge encoder: train-mode outputs and running statistics on a planned
    batch."""
    js = _molecules(4, seed=8, edge_dim=2)
    ts = _to_port(port, js)
    deg = gather_deg(js)
    tcfg = _cfg(port.spec, "PNA", deg=deg, gps=False, edge_dim=2)
    model = port.create.create_model(tcfg, "cpu", seed=1)
    params, stats = _jax_trees(model)
    assert "edge_encoder" in params["stack"]["conv_0"]
    jmodel = jcreate_model(_cfg(jspec, "PNA", deg=deg, gps=False, edge_dim=2))
    jb = jgraph.collate(js, with_segment_plan=True)

    def fwd(b):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats}, b, train=True,
                                mutable=["batch_stats"])
        return out, mut["batch_stats"]

    mp = pytest.MonkeyPatch()
    mp.setenv("HYDRAGNN_TPU_SEGMENT_IMPL", "pallas")  # read while tracing
    try:
        out, j_stats = jax.device_get(
            jax.jit(fwd).lower(jb).compile({"xla_backend_optimization_level": 0})(jb))
    finally:
        mp.undo()
    tb = port.graph.collate(ts, with_segment_plan=True)
    model.train()
    with port.torch.no_grad():
        got = model(tb)[0]
    real = tb.graph_mask.numpy()
    _assert_close(got.numpy()[real], np.asarray(out[0])[real], F32_TOL, "outputs")
    _check_stats(port, model, j_stats, F32_TOL)


@pytest.mark.parametrize("precision,planned", STEP_CASES)
def test_train_step_matches_jax(port, data, model_reference, precision, planned):
    """Loss, every gradient, every AdamW-updated parameter and every
    running statistic after one step of the port's make_train_step on
    the planned batch, then the eval-mode outputs from the step's
    statistics. Gradients and updates are held with the atol
    scaled by the largest over all parameters: some true gradients are
    zero (biases in front of a batch norm, which removes any shift; the
    attention's key bias, which softmax cancels), and both packages
    return rounding noise there."""
    torch = port.torch
    _, _, _, tbs, deg = data
    params, stats, want = model_reference
    _, j_stats, j_loss, j_grads, j_new = want[(precision, planned)]
    tcfg = _cfg(port.spec, deg=deg)
    model = _port_model(port, tcfg, params, stats)
    opt = port.optimizer.select_optimizer(model.parameters(), TRAINING)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
    step = port.loop.make_train_step(model, opt, tcfg, dt)
    k1, k2 = port.ep.edge_pipeline_planned.launches, port.ep.edge_pipeline_bwd_planned.launches
    _, loss, _ = step(port.loop.TrainState(model, opt), tbs[planned])
    # CPU tensors run the plain versions: no kernel launch
    assert (port.ep.edge_pipeline_planned.launches,
            port.ep.edge_pipeline_bwd_planned.launches) == (k1, k2)
    want_g = port.convert.params_from_jax(j_grads)
    want_p = port.convert.params_from_jax(j_new)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    tol = GRAD_TOL if precision == "f32" else BF16_TOL
    _assert_close(float(loss), float(j_loss), F32_TOL if precision == "f32" else tol, "loss")
    g_scale = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    p_scale = max(float(np.abs(p.numpy()).max()) for p in want_p.values())
    before = port.convert.params_from_jax(params)
    lr = TRAINING["Optimizer"]["learning_rate"]
    for name, p in named.items():
        g_ref = want_g[name].numpy()
        _assert_close(p.grad.numpy(), g_ref, tol, f"grad {name}", g_scale)
        # AdamW's first step moves an entry by lr x g / (|g| + eps): where
        # the reference gradient is within the gradient tolerance of zero
        # its sign is not determined, so such entries are held to a move
        # of at most lr (+ decay).
        got, ref, old = p.detach().numpy(), want_p[name].numpy(), before[name].numpy()
        same = np.isclose(got, ref, rtol=tol["rtol"], atol=tol["atol"] * min(p_scale, 1.0))
        noise = np.abs(g_ref) <= tol["atol"] * min(g_scale, 1.0)
        small_move = np.abs(got - old) <= lr * (1.0 + 1e-4 * np.abs(old)) * 1.001
        assert (same | (noise & small_move)).all(), (
            f"param {name}: {np.abs(got - ref).max():.3g} off at gradient "
            f"{np.abs(g_ref).max():.3g}")
    _check_stats(port, model, j_stats, F32_TOL if precision == "f32" else BF16_TOL)
    # Eval mode (validation, test, run_prediction) from the initial
    # parameters and those statistics: the updated parameters differ
    # where AdamW followed a noise gradient, and in eval mode a bias in
    # front of a batch norm is no longer cancelled.
    model = _port_model(port, tcfg, params, j_stats)
    model.eval()
    with torch.no_grad():
        got = model(port.loop.cast_batch(tbs[planned], dt))[0].float()
    real = tbs[planned].graph_mask.numpy()
    _assert_close(got.numpy()[real], np.asarray(want[("eval", precision)][0], np.float32)[real],
                  F32_TOL if precision == "f32" else BF16_TOL, "eval out")


def _zinc_config():
    import json

    with open(os.path.join(ZINC, "zinc.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def zinc_splits():
    """examples/zinc/zinc.py's 400 molecules (seed 0) split 0.8 as its
    main() splits them."""
    sys.path.insert(0, ZINC)
    try:
        from zinc import synthetic_zinc
    finally:
        sys.path.remove(ZINC)
    return jloader.split_dataset(synthetic_zinc(400), 0.8)


def test_zinc_packing_decision_matches_jax(port, zinc_splits):
    """On zinc.json (packing "auto", max_budgets 2) and zinc.py's set,
    the port's runner packs into the JAX package's budgets, and
    update_config derives the same config (pna_deg by gather_deg,
    max_neighbours from it, num_nodes kept); the samples keep their bond
    edges (no radius graph is built for datasets passed in)."""
    tr, va, te = zinc_splits
    ts = tuple(_to_port(port, d) for d in (tr, va, te))
    config = _zinc_config()
    ns, es = jpads.dataset_size_arrays(tr)
    want = jpads.packing_beats_ladder(ns, es, 64, max_budgets=2, seed=0)
    assert want is not None
    pk = port.runner.packing_settings(config)
    assert pk == {"enabled": "auto", "max_budgets": 2, "slack": None, "max_graphs": None}
    on, budgets, slack = port.runner.resolve_packing(pk, 64, ts[0], seed=0)
    assert on and slack == want[1]
    keys = [(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]
    assert keys == [(b.num_nodes, b.num_edges, b.num_graphs) for b in want[0]]
    assert keys == [(1440, 2920, 120), (720, 1464, 60)]
    # an explicit true fits the same budgets and slack
    on, budgets_t, slack_t = port.runner.resolve_packing(
        dict(pk, enabled=True), 64, ts[0], seed=0)
    assert on and budgets_t == budgets and slack_t == slack
    with pytest.raises(ValueError, match="not recognized"):
        port.runner.packing_settings(
            {"NeuralNetwork": {"Training": {"Parallelism": {"packing": {"enabled": "of"}}}}})
    full_j = jupdate_config(config, tr, va, te)
    full_t = port.config.update_config(config, *ts)
    assert full_t == full_j
    arch = full_t["NeuralNetwork"]["Architecture"]
    assert arch["max_neighbours"] == len(arch["pna_deg"]) - 1 and arch["num_nodes"] == 40
    sel = port.runner.select_input_features(ts[0], [0])
    assert all(a.edge_index is b.edge_index for a, b in zip(sel, ts[0]))


def test_packed_epochs_match_jax(port, zinc_splits):
    """The packed train loader's plans for two epochs and its first
    collated bin (arrays and block plan), and a fixed-order eval loader
    fitting its own budgets with the train slack, bit for bit."""
    tr, va, _ = zinc_splits
    ts, tv = _to_port(port, tr), _to_port(port, va)
    ns, es = jpads.dataset_size_arrays(tr)
    budgets, slack = jpads.packing_beats_ladder(ns, es, 64, max_budgets=2, seed=0)
    tbudgets = [port.graph.PackSpec(b.num_nodes, b.num_edges, b.num_graphs)
                for b in budgets]
    pairs = [
        (jloader.GraphLoader(tr, 64, shuffle=True, seed=0, packing=True,
                             pack_budgets=budgets, with_segment_plan=True),
         port.loader.GraphLoader(ts, 64, shuffle=True, seed=0, fixed_pad="auto",
                                 packing=True, pack_budgets=tbudgets)),
        (jloader.GraphLoader(va, 64, packing=True, pack_slack=slack),
         port.loader.GraphLoader(tv, 64, fixed_pad="auto", packing=True,
                                 pack_slack=slack, cache_batches=True)),
    ]
    for jl, tl in pairs:
        assert tl.planned_spec_keys() == jl.planned_spec_keys()
        for ep in (0, 1):
            jl.set_epoch(ep)
            tl.set_epoch(ep)
            want, got = list(jl.epoch_plan(ep)), list(tl.epoch_plan(ep))
            assert len(got) == len(want) == len(tl) == len(jl)
            for (wi, ws), (gi, gs) in zip(want, got):
                np.testing.assert_array_equal(gi, wi)
                assert (gs.num_nodes, gs.num_edges, gs.num_graphs) == (
                    ws.num_nodes, ws.num_edges, ws.num_graphs)
        assert tl.packing_stats() == jl.packing_stats()
    jl, tl = pairs[0]
    jl.set_epoch(0)
    tl.set_epoch(0)
    jb, tb = next(iter(jl)), next(iter(tl))
    assert tb.seg_window is not None
    for name in ("x", "pos", "senders", "receivers", "node_slot", "node_graph_idx",
                 "node_mask", "edge_mask", "graph_mask", "pe", "rel_pe", "y_graph"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


def _run_config(epochs, optimizer):
    """zinc.json cut to the test widths, batch 16, on one device (the
    tests' JAX platform has 8 virtual CPU devices), packing as zinc.json
    asks ("auto", 2 budgets), with ``optimizer`` (a ``Training.Optimizer``
    section)."""
    config = _zinc_config()
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=16, num_conv_layers=2, global_attn_heads=2, pe_dim=PE_DIM)
    arch["output_heads"]["graph"].update(dim_sharedlayers=16, dim_headlayers=[16, 16])
    training = config["NeuralNetwork"]["Training"]
    training.update(num_epoch=epochs, batch_size=16)
    training["Optimizer"] = optimizer
    training["Parallelism"]["scheme"] = "single"
    config["Verbosity"] = {"level": 0}
    return config


def _zinc_splits():
    splits = jloader.split_dataset(_molecules(80, seed=9, n_lo=8, n_hi=30), 0.8)
    ns, es = jpads.dataset_size_arrays(splits[0])
    assert jpads.packing_beats_ladder(ns, es, 16, max_budgets=2, seed=0) is not None
    return splits


def _jax_run(monkeypatch, splits, config, adam_eps=None, nudge=False):
    """The JAX package's run_training history and its initial ``(params,
    batch_stats)``. ``adam_eps`` replaces optax's AdamW epsilon (1e-8);
    ``nudge`` moves every initial parameter up by one ulp."""
    captured = {}

    def spy(model, example, seed=0):
        params, stats = jax.device_get(
            jax.jit(lambda b: init_params(model, b, seed=seed))(example))
        if nudge:
            params = jax.tree_util.tree_map(
                lambda x: np.nextafter(x, np.float32(np.inf)).astype(x.dtype), params)
        captured["vars"] = (params, stats)
        return params, stats

    with monkeypatch.context() as mp:
        mp.setattr(jrunner, "init_params", spy)
        if adam_eps is not None:
            import optax

            lr = config["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"]
            mp.setattr(jrunner, "select_optimizer", lambda training: optax.inject_hyperparams(
                optax.adamw)(learning_rate=lr, eps=adam_eps))
        hist = hydragnn_tpu.run_training(copy.deepcopy(config), datasets=splits)[3]
    return hist, captured["vars"]


def _port_run(port, monkeypatch, splits, config, variables, adam_eps=None):
    """The port's run_training (state, model, cfg, history, config) from
    the JAX run's initial ``variables``, with ``adam_eps`` as AdamW's
    epsilon where given; and its test split."""
    sd = port.convert.params_from_jax(*variables)
    make = port.runner.create_model_config

    def with_jax_params(config, device=None, *, seed=0):
        model, cfg = make(config, device, seed=seed)
        model.load_state_dict(sd)
        return model, cfg

    monkeypatch.setattr(port.runner, "create_model_config", with_jax_params)
    if adam_eps is not None:
        monkeypatch.setattr(port.optimizer, "_ADAM_EPS", adam_eps)
    t_splits = tuple(_to_port(port, s) for s in splits)
    return port.runner.run_training(config, datasets=t_splits, device="cpu"), t_splits


def _gaps(got, want):
    """Each history's largest relative gap between two runs."""
    return {name: float(np.max(np.abs(np.subtract(getattr(got, name), getattr(want, name)))
                               / np.abs(getattr(want, name))))
            for name in ("train_loss", "val_loss", "test_loss")}


@pytest.mark.slow
def test_zinc_run_training_matches_jax(port, monkeypatch, tmp_path):
    """Two epochs of run_training on 80 ZINC-like molecules with packing
    "auto" (which packs here, in both packages) from the same initial
    parameters and batch statistics, with SGD in place of zinc.json's
    AdamW: every per-epoch loss equals JAX's, and run_prediction's error
    equals the last test loss (AdamW's eval-mode losses are not
    determined that closely by the inputs: see the next test)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    splits = _zinc_splits()
    config = _run_config(2, {"type": "SGD", "learning_rate": 0.05})
    j_hist, variables = _jax_run(monkeypatch, splits, config)
    (state, model, cfg, t_hist, full), t_splits = _port_run(
        port, monkeypatch, splits, config, variables)
    for name in ("train_loss", "val_loss", "test_loss"):
        _assert_close(getattr(t_hist, name), getattr(j_hist, name), GRAD_TOL, name)
    err, _, trues, preds = port.runner.run_prediction(
        full, datasets=t_splits, state=state, model=model, cfg=cfg)
    assert preds[0].shape == trues[0].shape and np.isfinite(preds[0]).all()
    np.testing.assert_allclose(err, t_hist.test_loss[-1], rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("adam_eps", [None, 1e-5], ids=["adamw", "adamw-eps-1e-5"])
def test_zinc_run_training_adamw_matches_jax(port, monkeypatch, tmp_path, adam_eps):
    """zinc.json's AdamW, as the previous test: the per-epoch train
    losses equal JAX's. With AdamW's epsilon at 1e-8 the validation and
    test losses (eval mode) are not determined to that tolerance by the
    inputs: AdamW moves an entry by about lr x g / (|g| + eps), whose
    slope at g = 0 is lr / eps, so where a gradient is within rounding
    of zero (whole leaves, such as biases in front of a batch norm, and
    single entries, such as weights fed by an input that is constant
    over the batch) rounding decides the move; train mode cancels such
    entries, eval mode reads running statistics that lag them. The JAX
    package run again from its initial parameters moved up by one ulp
    parts from itself there by more than the tolerance, which this
    holds. With epsilon 1e-5 in both packages (the slope 1,000 x
    smaller) every loss equals JAX's. Prints the gaps (run with -s)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    splits = _zinc_splits()
    config = _run_config(2, {"type": "AdamW", "learning_rate": 2e-3})
    j_hist, variables = _jax_run(monkeypatch, splits, config, adam_eps)
    (_, _, _, t_hist, _), _ = _port_run(port, monkeypatch, splits, config, variables,
                                        adam_eps)
    gaps = _gaps(t_hist, j_hist)
    _assert_close(t_hist.train_loss, j_hist.train_loss, GRAD_TOL, "train_loss")
    if adam_eps is None:
        self_gaps = _gaps(_jax_run(monkeypatch, splits, config, nudge=True)[0], j_hist)
        print(f"\nAdamW eps 1e-8: largest relative gap per history, port vs JAX {gaps}, "
              f"JAX from parameters one ulp up vs JAX {self_gaps}")
        for name in ("val_loss", "test_loss"):
            assert self_gaps[name] > GRAD_TOL["rtol"], (name, self_gaps)
    else:
        print(f"\nAdamW eps {adam_eps:g}: largest relative gap per history, port vs JAX "
              f"{gaps}")
        for name in ("val_loss", "test_loss"):
            _assert_close(getattr(t_hist, name), getattr(j_hist, name), GRAD_TOL, name)
