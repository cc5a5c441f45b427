"""K2, the fused edge pipeline's pullback, against the JAX package.

- ``edge_pipeline_bwd_plain`` (what the port's backward runs on CPU
  tensors) against the JAX package's Pallas K2
  (``edge_pipeline_bwd_planned``, interpreted on the CPU) at the port's
  Hopper tiles: every flavour (a; a,b; a,W; a,b,W) in f32 on one plan
  with masked edges, an empty node window and static padding blocks,
  bf16 a/b with an f32 master W, a single block, and E=0;
- ``edge_pipeline_planned``'s operator (K1 forward, K2 backward) under
  ``torch.autograd.gradcheck`` in f64, and differentiated twice: a
  backward with ``create_graph=True`` gives K2's plain result with a
  graph, ``torch.autograd.gradgradcheck`` holds K2's operator
  (``edge_pipeline_bwd_planned``: K2 forward, K1/K2 backward) in every flavour, with invalid slots and
  at E=0, and its backward equals JAX's derivative of the XLA pullback
  (``_edge_pipeline_bwd_xla``) in every flavour;
- K1's plain version with bf16 a/b and an f32 W against the Pallas K1.

Tolerances (tests/test_pallas_segment.py:342 and :808): f32 gradients
rtol 1e-4 / atol 1e-3, bf16 rtol 4e-2 / atol 2.5e-1, with each atol
scaled by the reference's largest magnitude where that is below 1 (and
the magnitude asserted), so a near-zero port cannot pass.
"""

import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp

from hydragnn_tpu.ops import pallas_segment as jps

VJP_F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=4e-2, atol=2.5e-1)


def _assert_close(got, want, tol, name=""):
    scale = float(np.abs(want).max())
    assert scale > 1e-6, f"{name}: reference too small ({scale:g})"
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"], atol=tol["atol"] * min(scale, 1.0),
        err_msg=name,
    )


@pytest.fixture(scope="module")
def port():
    """torch and the port's kernels module, imported when this file runs
    rather than at collection."""
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch.ops import edge_pipeline

    return types.SimpleNamespace(torch=torch, ep=edge_pipeline)


@pytest.fixture(scope="module")
def case(port):
    """A plan at the Hopper tiles over 240 receiver-sorted edges:
    receivers skip nodes 32..63 (an empty window), about a tenth of the
    edges are masked out, and two static padding blocks follow."""
    rng = np.random.default_rng(19)
    n, e, f_in, f_out = 100, 240, 16, 24
    be, bn = port.ep.DEFAULT_BE, port.ep.DEFAULT_BN
    seg = np.sort(
        np.concatenate([rng.integers(0, 32, 120), rng.integers(64, n, 120)])
    ).astype(np.int32)
    ev = rng.random(e) > 0.1
    plan = jps.plan_blocks_static(
        seg, n, jps.static_block_bound(e, n, be, bn) + 2, be, bn, edge_valid=ev
    )
    assert not plan[2][-be:].any()  # static padding block present
    ops = {
        "a": rng.normal(size=(e, f_in)).astype(np.float32),
        "b": rng.normal(size=(e, f_in)).astype(np.float32),
        "w": (rng.normal(size=(f_in, f_out)) / 4).astype(np.float32),
        "g_in": rng.normal(size=(n, f_in)).astype(np.float32),
        "g_out": rng.normal(size=(n, f_out)).astype(np.float32),
    }
    return n, be, bn, plan, ev, ops


def _operands(ops, stages, cast):
    return (
        cast(ops["a"]),
        cast(ops["b"]) if "b" in stages else None,
        cast(ops["w"]) if "w" in stages else None,
        cast(ops["g_out"] if "w" in stages else ops["g_in"]),
    )


def _jax_bwd(ops, plan, n, be, bn, stages, dt):
    jdt = jnp.dtype(dt)
    a, b, w, g = _operands(ops, stages, jnp.asarray)
    a = a.astype(jdt)
    b = None if b is None else b.astype(jdt)  # w stays the f32 master
    g = g.astype(jnp.promote_types(jdt, w.dtype) if w is not None else jdt)
    return jps.edge_pipeline_bwd_planned(
        g, a, b, w, *(jnp.asarray(p) for p in plan), n, bn, be
    )


def _port_bwd(port, ops, plan, n, be, bn, stages, dt):
    torch = port.torch
    tdt = getattr(torch, dt)
    a, b, w, g = _operands(ops, stages, torch.from_numpy)
    a = a.to(tdt)
    b = None if b is None else b.to(tdt)
    g = g.to(torch.promote_types(tdt, w.dtype) if w is not None else tdt)
    return port.ep.edge_pipeline_bwd_planned(
        g, a, b, w, *(torch.from_numpy(p) for p in plan), n, bn, be
    )


@pytest.mark.parametrize("stages", ["a", "ab", "aw", "abw"])
def test_k2_plain_matches_pallas_f32(port, case, stages):
    """Each flavour in f32: d_a, d_b and d_W of the port's plain pullback
    equal the Pallas K2's; masked and padding edges get exactly zero."""
    n, be, bn, plan, ev, ops = case
    want = _jax_bwd(ops, plan, n, be, bn, stages, "float32")
    got = _port_bwd(port, ops, plan, n, be, bn, stages, "float32")
    assert (got[1] is None) == ("b" not in stages)
    assert (got[2] is None) == ("w" not in stages)
    for name, g, w in zip("abw", got, want):
        if w is None:
            continue
        assert g.dtype == port.torch.float32 and tuple(g.shape) == w.shape
        _assert_close(g.numpy(), np.asarray(w), VJP_F32_TOL, f"d{name} {stages}")
    for g in got[:2]:
        if g is not None:
            assert not g.numpy()[~ev].any()


def test_k2_plain_matches_pallas_bf16_f32_master(port, case):
    """bf16 a/b with an f32 master W (an f32 cotangent): d_a/d_b come
    back in bf16 and d_W in f32, within the bf16 tolerance."""
    n, be, bn, plan, _, ops = case
    torch = port.torch
    want = _jax_bwd(ops, plan, n, be, bn, "abw", "bfloat16")
    got = _port_bwd(port, ops, plan, n, be, bn, "abw", "bfloat16")
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for name, g, w in zip("abw", got, want):
        assert np.asarray(w).dtype == (np.float32 if name == "w" else jnp.bfloat16)
        _assert_close(
            g.float().numpy(), np.asarray(w, np.float32), BF16_TOL, f"d{name}"
        )


def test_k2_single_block_and_empty_edges(port):
    """A sub-tile edge array (one block, E < be) matches the Pallas K2;
    E=0 gives empty d_a and zero d_W, as the JAX pullback does."""
    torch = port.torch
    be, bn = port.ep.DEFAULT_BE, port.ep.DEFAULT_BN
    rng = np.random.default_rng(59)
    e, n, f = 37, 12, 16
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    plan = jps.plan_sorted_blocks(seg, n, be, bn)
    assert plan[3].shape[0] == 1  # single block
    a, b, g = (rng.normal(size=s).astype(np.float32) for s in ((e, f), (e, f), (n, f)))
    want = jps.edge_pipeline_bwd_planned(
        jnp.asarray(g), jnp.asarray(a), jnp.asarray(b), None,
        *(jnp.asarray(p) for p in plan), n, bn, be,
    )
    got = port.ep.edge_pipeline_bwd_planned(
        *(torch.from_numpy(x) for x in (g, a, b)), None,
        *(torch.from_numpy(p) for p in plan), n, bn, be,
    )
    for name, gt, wt in zip("ab", got, want):
        _assert_close(gt.numpy(), np.asarray(wt), VJP_F32_TOL, f"d{name}")
    # E = 0: the JAX pullback (through the custom VJP, reduce-only as
    # tests/test_pallas_segment.py runs it) against the port's.
    plan0 = tuple(
        torch.from_numpy(p) for p in jps.plan_sorted_blocks(np.zeros(0, np.int32), n, be, bn)
    )
    _, vjp0 = jax.vjp(
        lambda x: jps.edge_pipeline_planned(
            x, None, None, *(jnp.asarray(p.numpy()) for p in plan0), n, bn, be
        ),
        jnp.zeros((0, f), jnp.float32),
    )
    (j_da,) = vjp0(jnp.ones((n, f), jnp.float32))
    t_da, t_db, t_dw = port.ep.edge_pipeline_bwd_planned(
        torch.ones(n, f), torch.zeros(0, f), None, None, *plan0, n, bn, be
    )
    assert t_db is None and t_dw is None
    assert tuple(t_da.shape) == j_da.shape == (0, f)
    # with W the port gives a zero d_W (the JAX XLA pullback cannot
    # gather from an empty edge array there)
    _, _, t_dw = port.ep.edge_pipeline_bwd_planned(
        torch.ones(n, 8), torch.zeros(0, f), None, torch.ones(f, 8), *plan0, n, bn, be
    )
    assert t_dw.shape == (f, 8) and not t_dw.any()


@pytest.mark.parametrize("stages", ["a", "ab", "aw", "abw"])
def test_edge_pipeline_fn_gradcheck(port, stages):
    """The autograd function's K2 backward against finite differences of
    its K1 forward, in f64 on the CPU path, with masked edges, an empty
    window and static padding."""
    torch = port.torch
    ep = port.ep
    rng = np.random.default_rng(7)
    n, e, f_in, f_out, be, bn = 20, 30, 3, 2, 8, 4
    seg = np.sort(np.concatenate([rng.integers(0, 6, 15), rng.integers(12, n, 15)]))
    plan = ep.plan_blocks_static(
        seg.astype(np.int32), n, ep.static_block_bound(e, n, be, bn) + 1, be, bn,
        edge_valid=rng.random(e) > 0.2,
    )
    plan = [torch.from_numpy(p) for p in plan]
    ins = {
        "a": torch.tensor(rng.normal(size=(e, f_in)), requires_grad=True),
        "b": torch.tensor(rng.normal(size=(e, f_in)), requires_grad=True),
        "w": torch.tensor(rng.normal(size=(f_in, f_out)), requires_grad=True),
    }
    used = [k for k in "abw" if k in stages]

    def fn(*xs):
        ops = dict(zip(used, xs))
        return ep.edge_pipeline_planned(
            ops["a"], ops.get("b"), ops.get("w"), *plan, n, bn, be
        )

    assert torch.autograd.gradcheck(fn, tuple(ins[k] for k in used))


def _small_plan(port, rng, n=12, e=40, be=8, bn=4):
    """A plan at small tiles over ``e`` receiver-sorted edges: an empty
    window (nodes 4..7), a fifth of the edges masked out, and a static
    padding block."""
    ep = port.ep
    seg = np.sort(np.concatenate([rng.integers(0, 4, e // 2), rng.integers(8, n, e - e // 2)]))
    plan = ep.plan_blocks_static(
        seg.astype(np.int32), n, ep.static_block_bound(e, n, be, bn) + 1, be, bn,
        edge_valid=rng.random(e) > 0.2,
    )
    assert not plan[2].all()
    return [port.torch.from_numpy(p) for p in plan], (n, bn, be)


@pytest.mark.parametrize("stages", ["a", "ab", "aw", "abw", "abw_E0"])
def test_edge_pipeline_fn_gradgradcheck(port, stages):
    """Second derivatives of K1's operator (their analytic side is K2's
    operator's derivative, written with K1 and K2) against
    finite differences of its first derivatives, in f64 on the CPU path
    (E=40, N=12, F 3 -> 2; masked edges, an empty window, static
    padding), and at E=0."""
    torch = port.torch
    rng = np.random.default_rng(11)
    plan, sizes = _small_plan(port, rng)
    e = 0 if stages.endswith("E0") else 40
    # torch.empty gives row strides at E=0 too, where gradcheck refuses
    # the stride-0 layout of an empty numpy draw
    ins = {k: torch.empty(shape, dtype=torch.float64)
           .copy_(torch.from_numpy(rng.normal(size=shape))).requires_grad_(True)
           for k, shape in (("a", (e, 3)), ("b", (e, 3)), ("w", (3, 2)))}
    used = [k for k in "abw" if k in stages]

    def fn(*xs):
        ops = dict(zip(used, xs))
        return port.ep.edge_pipeline_planned(
            ops["a"], ops.get("b"), ops.get("w"), *plan, *sizes
        )

    assert torch.autograd.gradgradcheck(fn, tuple(ins[k] for k in used))


@pytest.mark.parametrize("stages", ["a", "ab", "aw", "abw"])
def test_edge_pipeline_bwd_fn_matches_jax_vjp(port, case, stages):
    """K2's operator's derivative (K1 and K2 plain versions plus
    elementwise ops) equals JAX's derivative of its XLA pullback
    ``_edge_pipeline_bwd_xla`` for the same cotangents of (d_a, d_b,
    d_W), in f32: the gradients with respect to g, a, b and W."""
    torch = port.torch
    n, be, bn, plan, _, ops = case
    has_b, has_w = "b" in stages, "w" in stages
    g = ops["g_out"] if has_w else ops["g_in"]
    e, f_in = ops["a"].shape
    rng = np.random.default_rng(23)
    cot = [rng.normal(size=(e, f_in)).astype(np.float32)]
    if has_b:
        cot.append(rng.normal(size=(e, f_in)).astype(np.float32))
    if has_w:
        cot.append(rng.normal(size=ops["w"].shape).astype(np.float32))
    names = ["g", "a"] + (["b"] if has_b else []) + (["w"] if has_w else [])
    prim = {"g": g, "a": ops["a"], "b": ops["b"], "w": ops["w"]}
    jplan = [jnp.asarray(p) for p in plan]

    def jfn(*xs):
        d = dict(zip(names, xs))
        out = jps._edge_pipeline_bwd_xla(
            d["a"], d.get("b"), d.get("w"), jplan[0], jplan[1], jplan[2], d["g"]
        )
        return tuple(o for o in out if o is not None)

    _, vjp = jax.vjp(jfn, *(jnp.asarray(prim[k]) for k in names))
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    tins = {k: torch.from_numpy(prim[k]).requires_grad_(True) for k in names}
    outs = port.ep.edge_pipeline_bwd_planned(
        tins["g"], tins["a"], tins.get("b"), tins.get("w"),
        *(torch.from_numpy(p) for p in plan), n, bn, be,
    )
    got = torch.autograd.grad(
        [o for o in outs if o is not None], [tins[k] for k in names],
        [torch.from_numpy(c) for c in cot], allow_unused=True,
    )
    for k, x, y in zip(names, got, want):
        if not np.abs(np.asarray(y)).any():  # d_a does not depend on a
            assert x is None or not x.any(), k
            continue
        _assert_close(x.numpy(), np.asarray(y), VJP_F32_TOL, f"{stages} d/d{k}")


def test_edge_pipeline_twice_differentiated_raises(port, case):
    """A backward asked for a graph (forces of an interatomic potential)
    now returns K2's plain result with a graph attached, where it once
    raised: the first derivative is unchanged and can be differentiated
    again."""
    torch = port.torch
    n, be, bn, plan, _, ops = case
    plan = [torch.from_numpy(p) for p in plan]
    a = torch.from_numpy(ops["a"]).requires_grad_(True)
    w = torch.from_numpy(ops["w"]).requires_grad_(True)
    out = port.ep.edge_pipeline_planned(a, None, w, *plan, n, bn, be)
    (da,) = torch.autograd.grad(out.sum(), a, create_graph=True)
    want = port.ep.edge_pipeline_bwd_plain(
        torch.ones(n, w.shape[1]), a.detach(), None, w.detach(), *plan, n, bn, be
    )[0]
    assert da.requires_grad and da.shape == a.shape
    np.testing.assert_array_equal(da.detach().numpy(), want.numpy())
    (dw,) = torch.autograd.grad(da.square().sum(), w)  # differentiable again
    assert dw.shape == w.shape and bool(dw.abs().sum() > 0)


@pytest.mark.parametrize("stages", ["aw", "abw"])
def test_k1_plain_bf16_with_f32_master_matches_pallas(port, case, stages):
    """K1 with bf16 a/b and an f32 W: the output is f32 (promote(a, W))
    on both sides and equal within the bf16 tolerance."""
    torch = port.torch
    n, be, bn, plan, _, ops = case
    a = jnp.asarray(ops["a"], jnp.bfloat16)
    b = jnp.asarray(ops["b"], jnp.bfloat16) if "b" in stages else None
    want = jps.edge_pipeline_planned(
        a, b, jnp.asarray(ops["w"]), *(jnp.asarray(p) for p in plan), n, bn, be
    )
    got = port.ep.edge_pipeline_planned(
        torch.from_numpy(ops["a"]).bfloat16(),
        torch.from_numpy(ops["b"]).bfloat16() if "b" in stages else None,
        torch.from_numpy(ops["w"]),
        *(torch.from_numpy(p) for p in plan), n, bn, be,
    )
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _assert_close(got.numpy(), np.asarray(want), BF16_TOL, stages)
    # the same function at the f32 tolerance once the bf16 rounding of
    # the inputs is shared: both compute in f32 from the rounded values
    _assert_close(got.numpy(), np.asarray(want), dict(rtol=1e-5, atol=1e-4), stages)
