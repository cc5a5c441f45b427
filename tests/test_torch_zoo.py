"""The invariant zoo slice against the JAX package, on the CPU.

Inputs are examples/open_polymers_2026's synthetic chains (its
``polymer_chain``, seed 26; the port's copy in tests/_torch_polymers.py
is held to it bit for bit), with a random ``graph_attr`` added, collated
by both packages with the block plan. Parameters and running statistics
are the port's initial ones, carried to the JAX package as its
``params``/``batch_stats`` trees (``params_from_jax`` inverted). The JAX
side runs in one compiled call (at XLA's lowest backend optimisation):

- ``segment_std`` and ``segment_softmax``, values and gradients, over
  masked slots, an empty segment (the padding node) and tied maxima;
- for each of SAGE, GIN, MFC, CGCNN and GAT (2 layers, polymers.json's
  heads at width 8: a graph head and a conv node head): the train-mode
  outputs and the one AdamW step of ``make_train_step`` (loss,
  gradients, updated parameters, running statistics);
- a SAGE model under each graph-attribute conditioning mode (film,
  concat_node, fuse_pool): train-mode outputs and running statistics;
- the conv node head alone at polymers.json's widths (64 -> 64 -> 64 -> 1),
  forward and gradients in train mode, with the JAX package forced onto
  its Pallas kernels (interpreted; HYDRAGNN_TPU_SEGMENT_IMPL=
  pallas_fused) and the port on K1's and K2's plain versions in the
  a,W flavour with the mean.

The stacks' conv heads run the JAX package's XLA decomposition of the
same sum (aggregate, divide, then the matmul), which the port's planned
batch computes as one K1 call with the division after it. Also:
``recalibrate_batch_stats`` against the JAX package's on two batches;
``update_config`` on polymers.json and csce_gap.json; polymers.json's
packing decision and epoch plans, bit for bit.

Tolerances (ROADMAP "How parity is judged"): f32 forward rtol 1e-5 /
atol 1e-4, gradients and updated parameters rtol 1e-4 / atol 1e-3, each
atol scaled by the reference's largest magnitude where that is below 1;
a train step's gradients and updates by the largest over all parameters
(a bias in front of a batch norm has a true gradient of zero, and both
packages return rounding noise there; AdamW moves such an entry by about
lr x sign(noise), so where the reference gradient lies inside the
gradient tolerance the move is held to lr plus decay). The softmax does
not depend on its shift, so its gradient is held at the gradient
tolerance although the two packages may split a tied maximum's
(vanishing) share differently.

``slow``: the port trains GIN, SAGE, MFC (with bn_recalibration),
CGCNN, GAT, PNA and PNAPlus to tests/test_graphs.py's thresholds through
``run_training``, then predicts with ``run_prediction(config)`` alone.
"""

import contextlib
import copy
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from hydragnn_tpu.config import update_config as jupdate_config
from hydragnn_tpu.data import graph as jgraph
from hydragnn_tpu.data import loader as jloader
from hydragnn_tpu.data import padschedule as jpads
from hydragnn_tpu.models import base as jbase
from hydragnn_tpu.models import spec as jspec
from hydragnn_tpu.models.create import create_model as jcreate_model
from hydragnn_tpu.ops import segment as jsegment
from hydragnn_tpu.train.losses import multihead_loss
from hydragnn_tpu.train.loop import recalibrate_batch_stats as jrecalibrate
from hydragnn_tpu.train.optimizer import select_optimizer as jselect_optimizer
from hydragnn_tpu.train.state import create_train_state

from tests import _torch_polymers

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples")
F32_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
LR = 5e-4  # polymers.json
TRAINING = {"Optimizer": {"type": "AdamW", "learning_rate": LR}}
STACKS = ("SAGE", "GIN", "MFC", "CGCNN", "GAT")
MODES = ("film", "concat_node", "fuse_pool")
ATTR_DIM = 2
HEAD_DIMS = ((64, 64), 1)  # polymers.json's conv node head: [64, 64] + 1
MAX_DEGREE = 2  # below the chains' largest degree (3), so MFC clips


def _assert_close(got, want, tol, name="", scale=None):
    """``got`` equals ``want`` at ``tol``'s rtol and its atol times
    min(scale, 1), ``scale`` being ``want``'s largest magnitude unless
    given."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 0.0
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0), err_msg=name
    )


@pytest.fixture(scope="module")
def port():
    """torch and the port's modules, imported when this file runs rather
    than at collection."""
    import types

    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import config, runner
    from hydragnn_tpu_torch.data import graph, loader
    from hydragnn_tpu_torch.models import base, convert, create, spec
    from hydragnn_tpu_torch.ops import edge_pipeline, segment
    from hydragnn_tpu_torch.train import loop, optimizer

    return types.SimpleNamespace(
        torch=torch, config=config, runner=runner, graph=graph, loader=loader,
        base=base, convert=convert, create=create, spec=spec, ep=edge_pipeline,
        segment=segment, loop=loop, optimizer=optimizer,
    )


def _example_chain():
    """examples/open_polymers_2026/train.py's ``polymer_chain``."""
    path = os.path.join(EXAMPLES, "open_polymers_2026", "train.py")
    spec = importlib.util.spec_from_file_location("_open_polymers_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.polymer_chain


FIELDS = ("x", "edge_index", "y_graph", "y_node", "graph_attr")


def _to_port(port, samples):
    return [port.graph.GraphSample(**{f: getattr(s, f) for f in FIELDS}) for s in samples]


@pytest.fixture(scope="module")
def data(port):
    """Four chains (the example's first four at seed 26) with a random
    2-wide ``graph_attr``, collated by both packages with the plan at one
    pad; and the same chains as two batches of two at that pad (the
    recalibration's feed)."""
    chain = _example_chain()
    rng = np.random.default_rng(26)
    js = [chain(rng) for _ in range(4)]
    attrs = np.random.default_rng(1).normal(size=(4, ATTR_DIM)).astype(np.float32)
    js = [dataclasses.replace(s, graph_attr=a) for s, a in zip(js, attrs)]
    ts = _to_port(port, js)
    pad = jgraph.PadSpec.for_samples(js)
    tpad = port.graph.PadSpec(pad.num_nodes, pad.num_edges, pad.num_graphs)
    jb = jgraph.collate(js, pad, with_segment_plan=True)
    tb = port.graph.collate(ts, tpad, with_segment_plan=True)
    assert tb.seg_window is not None and not tb.edge_mask.numpy().all()
    pairs = [(jgraph.collate(js[i:i + 2], pad), port.graph.collate(ts[i:i + 2], tpad))
             for i in (0, 2)]
    return js, ts, jb, tb, pairs


def test_polymer_chain_copy_matches_example(port):
    """tests/_torch_polymers.py's chains equal the example's, array for
    array, for its seed."""
    chain = _example_chain()
    rj, rt = np.random.default_rng(26), np.random.default_rng(26)
    for _ in range(20):
        a, b = chain(rj), _torch_polymers.polymer_chain(rt)
        for f in ("x", "edge_index", "y_graph", "y_node"):
            got, want = getattr(b, f), getattr(a, f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)


def _cfg(spec, mpnn_type, mode=None):
    """polymers.json's model at test widths: 2 layers of width 8 (CGCNN:
    the input width, 3), a graph head 1x8 + [8] and a conv node head [8]
    + 1; ``mode`` turns on graph-attribute conditioning."""
    kw = {}
    if mode is not None:
        kw = dict(use_graph_attr_conditioning=True, graph_attr_conditioning_mode=mode,
                  graph_attr_dim=ATTR_DIM)
    return spec.ModelConfig(
        mpnn_type=mpnn_type, input_dim=3, hidden_dim=3 if mpnn_type == "CGCNN" else 8,
        num_conv_layers=2,
        heads=(spec.HeadSpec("y", "graph", 1), spec.HeadSpec("s", "node", 1)),
        graph_branches=(spec.BranchSpec(num_sharedlayers=1, dim_sharedlayers=8,
                                        num_headlayers=1, dim_headlayers=(8,)),),
        node_branches=(spec.BranchSpec(num_headlayers=1, dim_headlayers=(8,),
                                       node_head_type="conv"),),
        task_weights=(1.0, 1.0), max_neighbours=MAX_DEGREE, **kw,
    )


def _jax_trees(state_dict):
    """A port ``state_dict`` as the JAX package's ``params`` and
    ``batch_stats`` trees (Linear weights transposed into Dense kernels;
    DenseParams kernels and every other leaf as they are)."""
    params, stats = {}, {}
    for key, t in state_dict.items():
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


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _op_inputs(jb):
    """Edge logits [E, 2] with masked slots and, at three receivers, a
    tied maximum; cotangents for std [N, 3] and softmax [E, 2]."""
    rng = np.random.default_rng(3)
    e = jb.num_edges
    logits = rng.normal(size=(e, 2)).astype(np.float32)
    rcv, mask = np.asarray(jb.receivers), np.asarray(jb.edge_mask)
    tied = []
    for r in np.unique(rcv[mask]):
        idx = np.nonzero((rcv == r) & mask)[0]
        if len(idx) >= 2 and len(tied) < 3:
            logits[idx[:2]] = 5.0 + len(tied)
            tied.append(idx[:2])
    assert len(tied) == 3
    data = rng.normal(size=(e, 3)).astype(np.float32)
    return dict(logits=logits, data=data,
                cot_std=rng.normal(size=(jb.num_nodes, 3)).astype(np.float32),
                cot_soft=rng.normal(size=(e, 2)).astype(np.float32), tied=tied)


@pytest.fixture(scope="module")
def reference(port, data):
    """Initial parameters (the port's, seed 1) and the JAX side of every
    comparison in one compiled call (module docstring)."""
    _, _, jb, tb, _ = data
    params = {m: _jax_trees(port.create.create_model(_cfg(port.spec, m), "cpu", seed=1)
                            .state_dict()) for m in STACKS}
    for mode in MODES:
        params[mode] = _jax_trees(port.create.create_model(
            _cfg(port.spec, "SAGE", mode), "cpu", seed=2).state_dict())
    head = port.base.ConvNodeHead(64, *HEAD_DIMS, "relu")
    port.create.init_flax_(head, seed=3)
    params["head"] = _jax_trees(head.state_dict())
    models = {m: jcreate_model(_cfg(jspec, m)) for m in STACKS}
    models.update({mode: jcreate_model(_cfg(jspec, "SAGE", mode)) for mode in MODES})
    jhead = jbase.ConvNodeHead(hidden_dims=HEAD_DIMS[0], output_dim=HEAD_DIMS[1], act="relu")
    tx = jselect_optimizer(TRAINING)
    ops = _op_inputs(jb)
    rng = np.random.default_rng(4)
    head_x = rng.normal(size=(jb.num_nodes, 64)).astype(np.float32)
    head_cot = rng.normal(size=(jb.num_nodes, 1)).astype(np.float32)

    def train_fwd(model, p, stats, batch):
        out, mut = model.apply({"params": p, "batch_stats": stats}, batch, train=True,
                               mutable=["batch_stats"])
        return out, mut["batch_stats"]

    def run(variables, batch):
        out = {}
        for m in STACKS:
            p, stats = variables[m]
            jcfg = _cfg(jspec, m)

            def loss(pp):
                outputs, new_bn = train_fwd(models[m], pp, stats, batch)
                return multihead_loss(outputs, batch, jcfg)[0], (outputs, new_bn)

            (tot, (outputs, new_bn)), grads = jax.value_and_grad(loss, has_aux=True)(p)
            # optax's AdamW is elementwise: on the raveled tree it gives the
            # same update and traces one leaf
            flat, unravel = ravel_pytree(p)
            new = create_train_state(flat, tx).apply_gradients(ravel_pytree(grads)[0], tx)
            out[m] = (outputs, new_bn, tot, grads, unravel(new.params))
        for mode in MODES:
            out[mode] = train_fwd(models[mode], *variables[mode], batch)
        hp, hstats = variables["head"]

        def head_loss(x, pp):
            y, mut = jhead.apply({"params": pp, "batch_stats": hstats}, x, batch,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(y * head_cot), (y, mut["batch_stats"])

        with _env("HYDRAGNN_TPU_SEGMENT_IMPL", "pallas_fused"):  # read while tracing
            out["head"] = jax.value_and_grad(head_loss, argnums=(0, 1), has_aux=True)(
                jnp.asarray(head_x), hp)

        def std(d):
            s = jsegment.segment_std(d, batch.receivers, batch.num_nodes, mask=batch.edge_mask)
            return jnp.sum(s * ops["cot_std"]), s

        def soft(lg):
            a = jsegment.segment_softmax(lg, batch.receivers, batch.num_nodes,
                                         mask=batch.edge_mask)
            return jnp.sum(a * ops["cot_soft"]), a

        out["std"] = jax.value_and_grad(std, has_aux=True)(jnp.asarray(ops["data"]))
        out["softmax"] = jax.value_and_grad(soft, has_aux=True)(jnp.asarray(ops["logits"]))
        return out

    compiled = jax.jit(run).lower(params, jb).compile({"xla_backend_optimization_level": 0})
    want = jax.device_get(compiled(params, jb))
    return params, want, dict(ops, head_x=head_x, head_cot=head_cot)


def test_segment_std_and_softmax_match_jax(port, data, reference):
    """Values and gradients of both ops over masked slots and the empty
    padding segment; the softmax with tied maxima sums to one at every
    receiver with an edge and is zero at masked slots."""
    torch = port.torch
    _, _, _, tb, _ = data
    _, want, ops = reference
    n, rcv, mask = tb.num_nodes, tb.receivers, tb.edge_mask
    empty = np.ones(n, bool)
    empty[rcv.numpy()[mask.numpy()]] = False
    assert empty.any()
    (_, j_std), j_gstd = want["std"]
    d = torch.from_numpy(ops["data"]).requires_grad_(True)
    s = port.segment.segment_std(d, rcv, n, mask=mask)
    (s * torch.from_numpy(ops["cot_std"])).sum().backward()
    _assert_close(s.detach().numpy(), j_std, F32_TOL, "std")
    np.testing.assert_allclose(s.detach().numpy()[empty], np.sqrt(1e-5), rtol=1e-6)
    _assert_close(d.grad.numpy(), j_gstd, GRAD_TOL, "std grad")
    (_, j_soft), j_gsoft = want["softmax"]
    lg = torch.from_numpy(ops["logits"]).requires_grad_(True)
    a = port.segment.segment_softmax(lg, rcv, n, mask=mask)
    (a * torch.from_numpy(ops["cot_soft"])).sum().backward()
    _assert_close(a.detach().numpy(), j_soft, F32_TOL, "softmax")
    # the softmax does not depend on its shift: gradient tolerance
    _assert_close(lg.grad.numpy(), j_gsoft, GRAD_TOL, "softmax grad")
    got = a.detach().numpy()
    assert not got[~mask.numpy()].any()
    sums = np.zeros((n, 2))
    np.add.at(sums, rcv.numpy()[mask.numpy()], got[mask.numpy()])
    np.testing.assert_allclose(sums[~empty], 1.0, rtol=1e-5)
    for i, j in ops["tied"]:
        np.testing.assert_array_equal(got[i], got[j])


def _port_model(port, tcfg, params, stats):
    model = port.create.create_model(tcfg, "cpu")
    model.load_state_dict(port.convert.params_from_jax(params, stats))
    return model


def _check_stats(port, model, j_stats, tol):
    """Running statistics, held unscaled (a norm after a norm sees a
    batch mean of rounding noise)."""
    got = model.state_dict()
    paths = port.convert.params_from_jax({}, j_stats)
    assert set(paths) == {k for k in got if k.endswith((".mean", ".var"))}
    for path, arr in paths.items():
        _assert_close(got[path].numpy(), arr.numpy(), tol, path, scale=1.0)


def _check_outputs(got, want, tb, what):
    real = {"graph": tb.graph_mask.numpy(), "node": tb.node_mask.numpy()}
    for hi, level in enumerate(("graph", "node")):
        _assert_close(got[hi].detach().numpy()[real[level]],
                      np.asarray(want[hi])[real[level]], F32_TOL, f"{what} head {hi}")


@pytest.mark.parametrize("mpnn_type", STACKS)
def test_stack_forward_and_train_step_match_jax(port, data, reference, mpnn_type):
    """Train-mode outputs (graph head and conv node head), then one step
    of the port's make_train_step: loss, every gradient, every
    AdamW-updated parameter and every running statistic."""
    torch = port.torch
    _, _, _, tb, _ = data
    params, want, _ = reference
    j_out, j_stats, j_loss, j_grads, j_new = want[mpnn_type]
    p0, s0 = params[mpnn_type]
    tcfg = _cfg(port.spec, mpnn_type)
    model = _port_model(port, tcfg, p0, s0)
    model.train()
    with torch.no_grad():
        _check_outputs(model(tb), j_out, tb, f"{mpnn_type} train")
    model = _port_model(port, tcfg, p0, s0)
    opt = port.optimizer.select_optimizer(model.parameters(), TRAINING)
    step = port.loop.make_train_step(model, opt, tcfg)
    k1, k2 = port.ep.edge_pipeline_planned.launches, port.ep.edge_pipeline_bwd_planned.launches
    _, loss, _ = step(port.loop.TrainState(model, opt), tb)
    # CPU tensors run the plain versions: no kernel launch
    assert (port.ep.edge_pipeline_planned.launches,
            port.ep.edge_pipeline_bwd_planned.launches) == (k1, k2)
    _assert_close(float(loss), float(j_loss), F32_TOL, "loss")
    want_g = port.convert.params_from_jax(j_grads)
    want_p = port.convert.params_from_jax(j_new)
    before = port.convert.params_from_jax(p0)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g) == set(want_p)
    g_scale = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    p_scale = max(float(np.abs(p.numpy()).max()) for p in want_p.values())
    for name, p in named.items():
        g_ref = want_g[name].numpy()
        _assert_close(p.grad.numpy(), g_ref, GRAD_TOL, f"grad {name}", g_scale)
        got, ref, old = p.detach().numpy(), want_p[name].numpy(), before[name].numpy()
        same = np.isclose(got, ref, rtol=GRAD_TOL["rtol"],
                          atol=GRAD_TOL["atol"] * min(p_scale, 1.0))
        noise = np.abs(g_ref) <= GRAD_TOL["atol"] * min(g_scale, 1.0)
        small_move = np.abs(got - old) <= LR * (1.0 + 1e-4 * np.abs(old)) * 1.001
        assert (same | (noise & small_move)).all(), (
            f"param {name}: {np.abs(got - ref).max():.3g} off at gradient "
            f"{np.abs(g_ref).max():.3g}")
    _check_stats(port, model, j_stats, F32_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_graph_attr_conditioning_matches_jax(port, data, reference, mode):
    """A SAGE model conditioned on ``graph_attr`` (film and concat_node
    after every conv layer, fuse_pool on the pooled features): train-mode
    outputs and running statistics."""
    _, _, _, tb, _ = data
    params, want, _ = reference
    j_out, j_stats = want[mode]
    model = _port_model(port, _cfg(port.spec, "SAGE", mode), *params[mode])
    assert "graph_conditioner" in params[mode][0]
    model.train()
    with port.torch.no_grad():
        _check_outputs(model(tb), j_out, tb, mode)
    _check_stats(port, model, j_stats, F32_TOL)


def test_conv_node_head_matches_jax(port, data, reference):
    """polymers.json's conv node head (64 -> 64 -> 64 -> 1) on the planned
    batch: K1's plain version in the a,W flavour with the mean at F_out
    64 and 1 forward, K2's backward, against the JAX package's Pallas
    kernels; outputs, running statistics and the gradients of the input
    and of every parameter."""
    torch = port.torch
    _, _, _, tb, _ = data
    params, want, inputs = reference
    (_, (j_y, j_stats)), (j_gx, j_gp) = want["head"]
    head = port.base.ConvNodeHead(64, *HEAD_DIMS, "relu")
    head.load_state_dict(port.convert.params_from_jax(*params["head"]))
    assert head.neigh_1.kernel.shape == (64, 64) and head.neigh_2.kernel.shape == (64, 1)
    head.train()
    x = torch.from_numpy(inputs["head_x"]).requires_grad_(True)
    k1 = port.ep.edge_pipeline_planned
    launches = (k1.launches, port.ep.edge_pipeline_bwd_planned.launches)
    calls = []
    plain = port.ep.edge_pipeline_plain

    def spy(a, b, w, *rest):
        calls.append((b is None, None if w is None else tuple(w.shape)))
        return plain(a, b, w, *rest)

    mp = pytest.MonkeyPatch()
    mp.setattr(port.ep, "edge_pipeline_plain", spy)
    try:
        y = head(x, tb)
        (y * torch.from_numpy(inputs["head_cot"])).sum().backward()
    finally:
        mp.undo()
    assert calls == [(True, (64, 64)), (True, (64, 64)), (True, (64, 1))]
    # CPU tensors run the plain versions: no kernel launch
    assert (k1.launches, port.ep.edge_pipeline_bwd_planned.launches) == launches
    real = tb.node_mask.numpy()
    _assert_close(y.detach().numpy()[real], np.asarray(j_y)[real], F32_TOL, "head out")
    _assert_close(x.grad.numpy(), j_gx, GRAD_TOL, "d x")
    want_g = port.convert.params_from_jax(j_gp)
    # scaled by the largest gradient: each self_{i} bias feeds a batch norm,
    # which cancels it, so its true gradient is zero (rounding noise)
    g_scale = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    for name, p in head.named_parameters():
        _assert_close(p.grad.numpy(), want_g[name].numpy(), GRAD_TOL, f"grad {name}",
                      g_scale)
    paths = port.convert.params_from_jax({}, j_stats)
    for path, arr in paths.items():
        _assert_close(head.state_dict()[path].numpy(), arr.numpy(), F32_TOL, path, scale=1.0)


def test_params_from_jax_dense_params_match(port):
    """A conv node head's neigh_{i} keeps its [in, out] kernel, SAGE's
    Dense lin_neigh is transposed, GIN's eps and GAT's att are copied."""
    tree = {"decoder": {"head1_b": {"neigh_0": {"kernel": np.ones((4, 2), np.float32)}}},
            "stack": {"conv_0": {"lin_neigh": {"kernel": np.ones((4, 2), np.float32)},
                                 "eps": np.float32(100.0),
                                 "att": np.ones((6, 2), np.float32)}}}
    sd = port.convert.params_from_jax(tree)
    assert sd["decoder.head1_b.neigh_0.kernel"].shape == (4, 2)
    assert sd["stack.conv_0.lin_neigh.weight"].shape == (2, 4)
    assert float(sd["stack.conv_0.eps"]) == 100.0
    assert sd["stack.conv_0.att"].shape == (6, 2)


def test_recalibrate_batch_stats_matches_jax(port, data, reference):
    """recalibrate_batch_stats over two batches of a trained-looking SAGE
    model (the conv head's batch norms included): the pooled running
    statistics against the JAX package's, and the parameters untouched."""
    _, _, _, _, pairs = data
    params, _, _ = reference
    p0, s0 = params["SAGE"]
    jcfg = _cfg(jspec, "SAGE")
    jstate = create_train_state(p0, jselect_optimizer(TRAINING), s0)
    jnew = jrecalibrate(jcreate_model(jcfg), jstate, [jb for jb, _ in pairs])
    j_stats = jax.device_get(jnew.batch_stats)
    model = _port_model(port, _cfg(port.spec, "SAGE"), p0, s0)
    before = {k: v.clone() for k, v in model.named_parameters()}
    state = port.loop.TrainState(model, port.optimizer.select_optimizer(
        model.parameters(), TRAINING))
    port.loop.recalibrate_batch_stats(model, state, [tb for _, tb in pairs],
                                      device=port.torch.device("cpu"))
    _check_stats(port, model, j_stats, F32_TOL)
    for k, v in model.named_parameters():
        assert port.torch.equal(v, before[k]), k
    # one of the pooled statistics moved away from the initial ones
    assert not np.allclose(j_stats["feature_norm_0"]["var"], 1.0)


def _example_config(*parts):
    import json

    with open(os.path.join(EXAMPLES, *parts)) as f:
        return json.load(f)


def _gap_samples(n=12, seed=5):
    """Chains with 9 node features, as csce_gap.json reads."""
    chain = _example_chain()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = chain(rng)
        x = np.concatenate([s.x, rng.normal(size=(s.x.shape[0], 6)).astype(np.float32)], 1)
        out.append(dataclasses.replace(s, x=x, y_node=None))
    return out


def _variant(mpnn_type, **arch):
    """polymers.json with another stack and Architecture keys."""
    config = _example_config("open_polymers_2026", "polymers.json")
    config["NeuralNetwork"]["Architecture"].update(mpnn_type=mpnn_type, **arch)
    return config


def test_update_config_matches_jax(port):
    """polymers.json (SAGE with a conv node head) and csce_gap.json (GAT)
    derive to the JAX package's config, as do polymers.json's variants
    that exercise the stack-specific defaulting: CGCNN's hidden_dim set
    to the input width, MFC's max_neighbours kept, GAT's edge_dim from
    edge_features. The port builds each model from it."""
    chain = _example_chain()
    rng = np.random.default_rng(26)
    poly = jloader.split_dataset([chain(rng) for _ in range(20)], 0.8)
    gap = jloader.split_dataset(_gap_samples(), 0.8)
    cases = [(_example_config("open_polymers_2026", "polymers.json"), poly),
             (_example_config("csce", "csce_gap.json"), gap),
             (_variant("CGCNN"), poly), (_variant("MFC", max_neighbours=10), poly),
             (_variant("GAT", edge_features=["bond"]), poly)]
    got_arch = {}
    for config, splits in cases:
        want = jupdate_config(copy.deepcopy(config), *splits)
        got = port.config.update_config(copy.deepcopy(config),
                                         *(_to_port(port, s) for s in splits))
        assert got == want
        arch = got["NeuralNetwork"]["Architecture"]
        port.create.create_model_config(got, "cpu")
        got_arch[(arch["mpnn_type"], bool(arch["edge_dim"]))] = arch
    assert got_arch[("GAT", False)]["hidden_dim"] == 60
    assert got_arch[("GAT", False)]["input_dim"] == 9
    assert got_arch[("CGCNN", False)]["hidden_dim"] == got_arch[("CGCNN", False)]["input_dim"] == 3
    assert got_arch[("MFC", False)]["max_neighbours"] == 10
    assert got_arch[("GAT", True)]["edge_dim"] == 1


def test_polymer_packing_matches_jax(port):
    """polymers.json's packing ("auto", batch 32) on the example's 300
    chains (seed 26, split 0.8): the port's runner decides as the JAX
    package decides, with the same budgets, and the train loader's plans
    for two epochs and its first batch equal the JAX loader's."""
    tr_p, _, _ = _torch_polymers.polymer_splits()
    chain = _example_chain()
    rng = np.random.default_rng(26)
    tr_j, _, _ = jloader.split_dataset([chain(rng) for _ in range(300)], 0.8)
    assert len(tr_j) == len(tr_p) == 240
    config = _torch_polymers.polymer_config()
    ns, es = jpads.dataset_size_arrays(tr_j)
    want = jpads.packing_beats_ladder(ns, es, 32, max_budgets=2, seed=0)
    pk = port.runner.packing_settings(config)
    on, budgets, slack = port.runner.resolve_packing(pk, 32, tr_p, seed=0)
    assert on == (want is not None)
    kw = {}
    if on:
        assert slack == want[1]
        assert ([(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]
                == [(b.num_nodes, b.num_edges, b.num_graphs) for b in want[0]])
        kw = dict(packing=True)
    jl = jloader.GraphLoader(tr_j, 32, shuffle=True, seed=0, with_segment_plan=True,
                             pack_budgets=want[0] if on else None, **kw)
    tl = port.loader.GraphLoader(tr_p, 32, shuffle=True, seed=0, fixed_pad="auto",
                                 pack_budgets=budgets, **kw)
    for ep in (0, 1):
        jl.set_epoch(ep)
        tl.set_epoch(ep)
        w, g = list(jl.epoch_plan(ep)), list(tl.epoch_plan(ep))
        assert len(w) == len(g)
        for (wi, ws), (gi, gs) in zip(w, g):
            np.testing.assert_array_equal(gi, wi)
            assert (gs.num_nodes, gs.num_edges, gs.num_graphs) == (
                ws.num_nodes, ws.num_edges, ws.num_graphs)
    jl.set_epoch(0)
    tl.set_epoch(0)
    jb, tb = next(iter(jl)), next(iter(tl))
    for name in ("x", "senders", "receivers", "node_mask", "edge_mask", "graph_mask",
                 "y_graph", "y_node"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


# ------------------------------------------------------------------ slow

THRESHOLDS = {  # tests/test_graphs.py:22-36 (head RMSE, sample MAE)
    "GIN": (0.25, 0.20), "SAGE": (0.20, 0.20), "MFC": (0.20, 0.30),
    "CGCNN": (0.50, 0.40), "GAT": (0.60, 0.70), "PNA": (0.20, 0.20),
    "PNAPlus": (0.20, 0.20),
}


@pytest.mark.slow
@pytest.mark.parametrize("mpnn_type", sorted(THRESHOLDS))
def test_stack_trains_to_threshold(port, tmp_path, monkeypatch, mpnn_type):
    """The port's stack on tests/test_graphs.py's BCC set (300
    configurations, seed 7, ci.json) reaches its thresholds, trained by
    run_training and then predicted by run_prediction(config) alone from
    the checkpoint the run wrote; MFC with bn_recalibration, as
    tests/test_graphs.py trains it."""
    import json

    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "dataset" / "unit_test")
    deterministic_graph_data(path, number_configurations=300, seed=7)
    with open(os.path.join(HERE, "inputs", "ci.json")) as f:
        config = json.load(f)
    config["Dataset"]["path"] = {"total": path}
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = mpnn_type
    training = config["NeuralNetwork"]["Training"]
    training["Parallelism"] = {"scheme": "single"}
    if mpnn_type == "MFC":
        training["bn_recalibration"] = {"enabled": True}
    port.runner.run_training(copy.deepcopy(config), device="cpu")
    _, _, trues, preds = port.runner.run_prediction(config, device="cpu")
    thr_rmse, thr_mae = THRESHOLDS[mpnn_type]
    for t, p in zip(trues, preds):
        assert float(np.sqrt(np.mean((t - p) ** 2))) < thr_rmse
        assert float(np.mean(np.abs(t - p))) < thr_mae
