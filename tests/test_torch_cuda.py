"""K1 and K2 on the card: the Hopper kernels against their plain versions
(at MACE's width F = 288 and PNAEq's 2, 3, 128 and 192 too); and
CUDA-graph capture of the train loop's steps (``train/capture.py``):
replayed train and eval steps, a K = 2 replay, every optimizer's captured
step and MACE's and PNAEq's MLIP steps against eager ones, bit for bit;
the divergence guard's step replayed against eager and unguarded, and a
poisoned step inside a replayed K = 2 graph skipped bit for bit; the
multibranch guard's per-slot step (world 1 over NCCL) eager and replayed
against the unguarded one, and a label poison contained; the
run telemetry: a run with the stream on equals it off, every step
replayed, and the dispatch-mode counter's K1/K2 counts equal
``k1_work``/``k2_work``; the input feed: run_training through the
collation workers and the prefetch thread equal to the serial feed bit
for bit, every step replayed; MD rollouts: K1/K2 on a block plan built
on the card equal their plain versions, and a captured K = 8 macro
equals K = 1 bit for bit; every run's eager steps on one side stream of
the card, so two run_trainings leave device memory flat.

These tests need a CUDA device and skip without one (the decision is
made inside each test). This file imports no JAX, so it also runs where
JAX is not installed; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

# tests/test_pallas_segment.py:341-342 and :808 — the fused kernels'
# forward and gradient tolerances.
TOL = {
    "float32": dict(rtol=1e-5, atol=1e-4),
    "bfloat16": dict(rtol=4e-2, atol=2.5e-1),
}
VJP_TOL = {
    "float32": dict(rtol=1e-4, atol=1e-3),
    "bfloat16": dict(rtol=4e-2, atol=2.5e-1),
}
# dtype mixes: (a/b, W); "bf16_f32w" is bf16 a/b with an f32 master W.
MIXES = {
    "float32": ("float32", "float32"),
    "bfloat16": ("bfloat16", "bfloat16"),
    "bf16_f32w": ("bfloat16", "float32"),
}


def _need_card():
    """torch, once a CUDA device is known to be there (imported here, not
    at collection, so test workers that never run this file do not load
    torch)."""
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _plan(seed, e_real, e_pad, n, be=64, bn=32):
    """A served-bin-like plan on the host: receiver-sorted real edges,
    padding edges and a tenth of the real ones masked out of the plan,
    static block padding. Returns (rng, (perm, seg_padded, valid,
    window_id))."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        plan_blocks_static,
        static_block_bound,
    )

    rng = np.random.default_rng(seed)
    seg = np.full(e_pad, n - 1, np.int64)
    seg[:e_real] = np.sort(rng.integers(0, n - 1, e_real))
    mask = np.zeros(e_pad, bool)
    mask[:e_real] = True
    mask[rng.integers(0, max(e_real, 1), e_real // 10)] = False
    plan = plan_blocks_static(
        seg, n, static_block_bound(e_pad, n, be, bn) + 2, be, bn,
        edge_valid=mask,
    )
    return rng, plan


def _case(torch, seed, e_real, e_pad, n, f_in, f_out, dtype, be=64, bn=32,
          w_dtype=None):
    """``_plan``'s case on the card with random a, b and W."""
    rng, plan = _plan(seed, e_real, e_pad, n, be, bn)
    dev = torch.device("cuda")
    a = torch.tensor(rng.normal(size=(e_pad, f_in)), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(size=(e_pad, f_in)), dtype=dtype, device=dev)
    w = torch.tensor(
        rng.normal(size=(f_in, f_out)) / np.sqrt(f_in), dtype=w_dtype or dtype,
        device=dev,
    )
    perm, seg_p, valid, window = (torch.from_numpy(p).to(dev) for p in plan)
    return a, b, w, perm, seg_p, valid, window


# (real edges, padded edges, nodes, F). The last two put more than 256
# valid slots in a node window (four of the kernels' 64-slot staged
# chunks, kSub in csrc/edge_tile.cuh), so node sums carry across many
# chunks and both ring stages: ~1,350 valid slots in each of 2 windows,
# and the headline train step's density (~265 per window) over 82
# windows, whose d_W partials K2 folds in order.
SHAPES = [(1250, 1280, 640, 128), (37, 64, 200, 16), (300, 304, 40, 128),
          (3000, 3072, 64, 128), (24000, 24576, 2600, 128)]
K_CHUNK = 256


def test_cuda_shapes_span_staging_passes():
    """The card's shapes include windows of more valid plan slots than
    one staging pass holds, and one with more than 64 windows (checked
    on the host, where the plans are built)."""
    most, windows = [], []
    for seed, (e_real, e_pad, n, _) in enumerate(SHAPES):
        _, (perm, seg_p, valid, window) = _plan(seed, e_real, e_pad, n)
        per_window = np.bincount(np.repeat(window, 64)[valid])
        most.append(int(per_window.max()))
        windows.append(int(window.max()) + 1)
    assert max(most[:3]) <= K_CHUNK < min(most[3:]), most
    assert windows[-1] > 64, windows


@pytest.mark.cuda
@pytest.mark.parametrize(
    "stages,dt",
    [(s, d) for d in ("float32", "bfloat16") for s in ("a", "ab", "abw")]
    + [("aw", "float32"), ("aw", "bf16_f32w"), ("abw", "bf16_f32w")],
)
def test_kernel_matches_plain(stages, dt):
    """K1 in each flavour and dtype mix equals its plain version within
    the fused kernel's tolerances, and two runs give the same bits; the
    output type is promote(a, W)."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a_dt, w_dt = (getattr(torch, x) for x in MIXES[dt])
    for seed, (e_real, e_pad, n, f) in enumerate(SHAPES):
        a, b, w, perm, seg_p, valid, window = _case(
            torch, seed, e_real, e_pad, n, f, f, a_dt, w_dtype=w_dt
        )
        b = b if "b" in stages else None
        w = w if "w" in stages else None
        args = (a, b, w, perm, seg_p, valid, window, n)
        with torch.no_grad():
            before = edge_pipeline_planned.launches
            got = edge_pipeline_planned(*args)
            again = edge_pipeline_planned(*args)
            ref = edge_pipeline_plain(*args)
        torch.cuda.synchronize()
        assert edge_pipeline_planned.launches == before + 2
        out_dt = torch.promote_types(a_dt, w_dt) if w is not None else a_dt
        assert got.dtype == ref.dtype == out_dt
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[MIXES[dt][0]])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "stages,dt",
    [(s, d) for d in ("float32", "bfloat16") for s in ("a", "ab", "aw", "abw")]
    + [("aw", "bf16_f32w"), ("abw", "bf16_f32w")],
)
def test_k2_matches_plain(stages, dt):
    """K2 in each flavour and dtype mix equals its plain version within
    the gradient tolerances, two runs give the same bits (no atomics),
    and masked or padding edges get exactly zero."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
    )

    a_dt, w_dt = (getattr(torch, x) for x in MIXES[dt])
    for seed, (e_real, e_pad, n, f) in enumerate(SHAPES):
        a, b, w, perm, seg_p, valid, window = _case(
            torch, seed, e_real, e_pad, n, f, f, a_dt, w_dtype=w_dt
        )
        b = b if "b" in stages else None
        w = w if "w" in stages else None
        g_dt = torch.promote_types(a_dt, w_dt) if w is not None else a_dt
        g = torch.randn(n, f, generator=torch.Generator().manual_seed(seed)).to("cuda", g_dt)
        args = (g, a, b, w, perm, seg_p, valid, window, n)
        before = edge_pipeline_bwd_planned.launches
        got = edge_pipeline_bwd_planned(*args)
        again = edge_pipeline_bwd_planned(*args)
        ref = edge_pipeline_bwd_plain(*args)
        torch.cuda.synchronize()
        assert edge_pipeline_bwd_planned.launches == before + 2
        covered = torch.zeros(a.shape[0], dtype=torch.bool, device="cuda")
        covered[perm[valid].long()] = True
        for name, x, y, z in zip("abw", got, again, ref):
            if z is None:
                assert x is None
                continue
            assert x.dtype == z.dtype and x.shape == z.shape, name
            assert torch.equal(x, y), name
            torch.testing.assert_close(x.float(), z.float(), **VJP_TOL[MIXES[dt][0]])
            if name != "w":
                assert not x[~covered].any(), name


# (F_in, F_out) past the headline's 128 -> 128: ragged slabs of 32 columns
# with F_in != F_out; more 32-column slabs (12) than one cluster of K1's
# CTAs holds (8), so K1 takes 64-column slabs there; and rows of a and b
# that are not a multiple of 16 bytes (20 columns), which the kernels
# stage with plain loads instead of 16-byte copies; and a conv node
# head's last layer (64 -> 1): one output column, so one of K1's two slab
# CTAs owns no output column, and g's rows are 4 bytes wide.
WIDTHS = [(48, 80), (384, 384), (20, 36), (64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("f_in,f_out", WIDTHS)
@pytest.mark.parametrize(
    "stages,dt",
    [(s, "float32") for s in ("a", "ab", "aw", "abw")]
    + [("abw", "bfloat16"), ("abw", "bf16_f32w")],
)
def test_kernels_ragged_and_wide(stages, dt, f_in, f_out):
    """K1 and K2 at widths other than the main path's: each equals its
    plain version (same bits on two runs), and K2 leaves exactly zero in
    the rows no valid slot covers. Without W the output width is F_in."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a_dt, w_dt = (getattr(torch, x) for x in MIXES[dt])
    e_real, e_pad, n = 1250, 1280, 640
    a, b, w, perm, seg_p, valid, window = _case(
        torch, 7, e_real, e_pad, n, f_in, f_out, a_dt, w_dtype=w_dt
    )
    b = b if "b" in stages else None
    w = w if "w" in stages else None
    width = f_out if w is not None else f_in
    plan = (perm, seg_p, valid, window, n)
    with torch.no_grad():
        got = edge_pipeline_planned(a, b, w, *plan)
        again = edge_pipeline_planned(a, b, w, *plan)
        ref = edge_pipeline_plain(a, b, w, *plan)
    g_dt = torch.promote_types(a_dt, w_dt) if w is not None else a_dt
    g = torch.randn(n, width, generator=torch.Generator().manual_seed(7)).to("cuda", g_dt)
    grads = edge_pipeline_bwd_planned(g, a, b, w, *plan)
    grads_again = edge_pipeline_bwd_planned(g, a, b, w, *plan)
    grads_ref = edge_pipeline_bwd_plain(g, a, b, w, *plan)
    torch.cuda.synchronize()
    assert got.shape == (n, width) and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[MIXES[dt][0]])
    covered = torch.zeros(a.shape[0], dtype=torch.bool, device="cuda")
    covered[perm[valid].long()] = True
    for name, x, y, z in zip("abw", grads, grads_again, grads_ref):
        if z is None:
            assert x is None
            continue
        assert x.dtype == z.dtype and x.shape == z.shape, name
        assert torch.equal(x, y), name
        torch.testing.assert_close(x.float(), z.float(), **VJP_TOL[MIXES[dt][0]])
        if name != "w":
            assert not x[~covered].any(), name


@pytest.mark.cuda
def test_kernel_edge_cases():
    """E=0 returns zeros without a launch; a plan built at the TPU's
    tiles (be=512, bn=256) runs through the same kernel; a gradient
    request (at the Hopper tiles: K2 stages three [bn, F] f32 tiles in
    shared memory, which bn=256 at F=128 overflows) runs K1 forward and
    K2 backward, one launch each, and gives the CPU path's gradients."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a, b, w, perm, seg_p, valid, window = _case(
        torch, 5, 900, 1024, 300, 128, 128, torch.float32, be=512, bn=256
    )
    with torch.no_grad():
        got = edge_pipeline_planned(
            a, b, w, perm, seg_p, valid, window, 300, bn=256, be=512
        )
        ref = edge_pipeline_plain(
            a, b, w, perm, seg_p, valid, window, 300, bn=256, be=512
        )
        torch.testing.assert_close(got, ref, **TOL["float32"])
        before = edge_pipeline_planned.launches
        z = edge_pipeline_planned(
            a[:0], b[:0], w, perm, seg_p, valid, window, 300
        )
        assert edge_pipeline_planned.launches == before
        assert z.shape == (300, 128) and not z.any()
    with pytest.raises(ValueError, match="smaller bn"):
        edge_pipeline_bwd_planned(
            torch.ones(300, 128, device="cuda"), a, b, w, perm, seg_p, valid,
            window, 300, bn=256, be=512,
        )
    a, b, w, perm, seg_p, valid, window = _case(
        torch, 6, 900, 1024, 300, 128, 128, torch.float32
    )
    args = [t.detach().clone().requires_grad_(True) for t in (a, b, w)]
    k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
    out = edge_pipeline_planned(*args, perm, seg_p, valid, window, 300)
    gout = torch.randn_like(out)
    grads = torch.autograd.grad(out, args, gout)
    torch.cuda.synchronize()
    assert (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches) == (
        k1 + 1, k2 + 1
    )
    cpu = [t.detach().cpu().requires_grad_(True) for t in (a, b, w)]
    out_c = edge_pipeline_planned(
        *cpu, *(t.cpu() for t in (perm, seg_p, valid, window)), 300
    )
    for got, want in zip(grads, torch.autograd.grad(out_c, cpu, gout.cpu())):
        torch.testing.assert_close(got.cpu(), want, **VJP_TOL["float32"])


# PaiNN's aggregation widths (md17.json: input width 1, hidden 64): the
# scalar and the folded vector message of layer 0 (F = 1, 3; rows of 4
# and 12 bytes, staged with plain loads, one or three live columns of a
# 32-column slab) and of the hidden layers (F = 64, 192: two and six
# slabs), reduce-only, at the MLIP train batch's density (32 molecules
# of 19-23 atoms: ~680 nodes, ~6,500 edges).
PAINN_WIDTHS = [1, 3, 64, 192]


@pytest.mark.cuda
@pytest.mark.parametrize("f", PAINN_WIDTHS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_kernels_painn_widths(f, dt):
    """K1 and K2 in the reduce-only flavour at PaiNN's widths: each equals
    its plain version (same bits on two runs), and K2 leaves exactly zero
    in the rows no valid slot covers."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a_dt = getattr(torch, dt)
    n = 680
    a, _, _, perm, seg_p, valid, window = _case(torch, 11, 6500, 6656, n, f, f, a_dt)
    plan = (perm, seg_p, valid, window, n)
    with torch.no_grad():
        got = edge_pipeline_planned(a, None, None, *plan)
        again = edge_pipeline_planned(a, None, None, *plan)
        ref = edge_pipeline_plain(a, None, None, *plan)
    g = torch.randn(n, f, generator=torch.Generator().manual_seed(f)).to("cuda", a_dt)
    d_a, d_b, d_w = edge_pipeline_bwd_planned(g, a, None, None, *plan)
    d_a2 = edge_pipeline_bwd_planned(g, a, None, None, *plan)[0]
    d_ref = edge_pipeline_bwd_plain(g, a, None, None, *plan)[0]
    torch.cuda.synchronize()
    assert got.shape == (n, f) and got.dtype == a_dt and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dt])
    assert d_b is None and d_w is None and d_a.dtype == a_dt
    assert torch.equal(d_a, d_a2)
    torch.testing.assert_close(d_a.float(), d_ref.float(), **VJP_TOL[dt])
    covered = torch.zeros(a.shape[0], dtype=torch.bool, device="cuda")
    covered[perm[valid].long()] = True
    assert not d_a[~covered].any()


@pytest.mark.cuda
@pytest.mark.parametrize("stages", ["a", "ab", "aw", "abw"])
def test_double_backward_matches_cpu(stages):
    """K2's operator on the card (K2 forward; K1 and K2 in its
    derivative, counted) against the same function on the CPU plain path:
    the first derivatives with a graph, then the gradients of a scalar
    of them with respect to a, b, W and the cotangent."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    n = 300
    a, b, w, perm, seg_p, valid, window = _case(torch, 8, 900, 1024, n, 48, 40,
                                                torch.float32)
    has_b, has_w = "b" in stages, "w" in stages
    gen = torch.Generator().manual_seed(8)
    g = torch.randn(n, 40 if has_w else 48, generator=gen).cuda()
    results = []
    for dev in ("cuda", "cpu"):
        ins = {k: x.detach().to(dev).requires_grad_(True)
               for k, x in (("g", g), ("a", a), ("b", b), ("w", w))}
        plan = [t.to(dev) for t in (perm, seg_p, valid, window)]
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        outs = edge_pipeline_bwd_planned(
            ins["g"], ins["a"], ins["b"] if has_b else None,
            ins["w"] if has_w else None, *plan, n, 32, 64,
        )
        # a scalar of the first derivatives whose cotangents are all
        # nonzero: the squares' sum
        loss = sum((o * o).sum() for o in outs if o is not None)
        names = ["g", "a"] + (["b"] if has_b else []) + (["w"] if has_w else [])
        grads = torch.autograd.grad(loss, [ins[k] for k in names], allow_unused=True)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert edge_pipeline_bwd_planned.launches > k2
            assert edge_pipeline_planned.launches > k1
        results.append([(o.detach().cpu() if o is not None else None) for o in outs]
                       + [(x.detach().cpu() if x is not None else None) for x in grads])
    for x, y in zip(*results):
        assert (x is None) == (y is None)
        if x is not None:
            torch.testing.assert_close(x, y, **VJP_TOL["float32"])


def _zinc_bin(seed=0, n_mols=320):
    """The first packed bin of ZINC-like bond graphs (12-32 atoms, a
    random tree plus ring closures, as examples/zinc/zinc.py draws them)
    packed into budgets fitted for batch 64 (zinc.json's), collated with
    the block plan: ~1,440 nodes, ~2,900 edges, up to 120 graph slots
    with a long run of padding nodes."""
    from hydragnn_tpu_torch.data.graph import GraphSample, collate
    from hydragnn_tpu_torch.data.padschedule import (
        dataset_size_arrays,
        epoch_batch_indices,
        fit_pack_budgets,
        pack_epoch_ffd,
    )

    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n_mols):
        n = int(rng.integers(12, 33))
        edges = [(i, int(rng.integers(0, i))) for i in range(1, n)]
        for _ in range(int(rng.integers(0, 4))):
            a, b = rng.integers(0, n, 2)
            if a != b:
                edges.append((int(a), int(b)))
        ei = np.array([[e[0] for e in edges] + [e[1] for e in edges],
                       [e[1] for e in edges] + [e[0] for e in edges]], np.int64)
        samples.append(GraphSample(
            x=rng.integers(6, 9, (n, 1)).astype(np.float32),
            pos=rng.uniform(0, 3, (n, 3)).astype(np.float32), edge_index=ei,
            y_graph=np.zeros(1, np.float32)))
    ns, es = dataset_size_arrays(samples)
    budgets = fit_pack_budgets(ns, es, 64, max_budgets=2, seed=0)
    order = np.concatenate(list(epoch_batch_indices(len(samples), 64, shuffle=True,
                                                    seed=0, epoch=0)))
    idx, spec = pack_epoch_ffd(order, ns, es, budgets)[0]
    return collate([samples[i] for i in idx], spec.pad_spec(), with_segment_plan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_kernels_pna_width(dt):
    """K1 and K2 in the reduce-only flavour at PNA's moment-pass width
    (F = 128: [h, h*h] at hidden 64) on a packed ZINC bin's plan: each
    equals its plain version (same bits on two runs), K2 zero off the
    plan."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a_dt = getattr(torch, dt)
    batch = _zinc_bin().to("cuda")
    n, e, f = batch.num_nodes, batch.num_edges, 128
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window, n)
    gen = torch.Generator().manual_seed(128)
    a = torch.randn(e, f, generator=gen).to("cuda", a_dt)
    g = torch.randn(n, f, generator=gen).to("cuda", a_dt)
    k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
    with torch.no_grad():
        got = edge_pipeline_planned(a, None, None, *plan)
        again = edge_pipeline_planned(a, None, None, *plan)
        ref = edge_pipeline_plain(a, None, None, *plan)
    d_a, d_b, d_w = edge_pipeline_bwd_planned(g, a, None, None, *plan)
    d_a2 = edge_pipeline_bwd_planned(g, a, None, None, *plan)[0]
    d_ref = edge_pipeline_bwd_plain(g, a, None, None, *plan)[0]
    torch.cuda.synchronize()
    assert (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2) == (2, 2)
    assert got.shape == (n, f) and got.dtype == a_dt and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dt])
    assert d_b is None and d_w is None and torch.equal(d_a, d_a2)
    torch.testing.assert_close(d_a.float(), d_ref.float(), **VJP_TOL[dt])
    covered = torch.zeros(e, dtype=torch.bool, device="cuda")
    covered[batch.seg_perm[batch.seg_valid].long()] = True
    assert not d_a[~covered].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_masked_batch_norm_on_card(dt):
    """MaskedBatchNorm on the card against the CPU: two train steps
    (outputs and f32 running statistics) over a packed bin's node mask,
    then eval mode."""
    torch = _need_card()
    from hydragnn_tpu_torch.models.layers import MaskedBatchNorm

    batch = _zinc_bin()
    mask = batch.node_mask
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(mask.shape[0], 64, generator=gen) * 3 + 1 for _ in range(2)]
    outs = {}
    for dev in ("cuda", "cpu"):
        bn = MaskedBatchNorm(64).to(dev)
        with torch.no_grad():
            bn.scale.copy_(torch.linspace(0.5, 1.5, 64))
            bn.bias.copy_(torch.linspace(-1, 1, 64))
        bn.train()
        got = [bn(x.to(dev, getattr(torch, dt)), mask.to(dev)) for x in xs]
        bn.eval()
        got.append(bn(xs[1].to(dev, getattr(torch, dt)), mask.to(dev)))
        outs[dev] = [o.detach().float().cpu() for o in got] + [bn.mean.cpu(), bn.var.cpu()]
    assert all(o.dtype == torch.float32 for o in outs["cuda"])
    for x, y in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(x, y, **TOL[dt])


@pytest.mark.cuda
def test_dense_batch_and_segment_min_on_card():
    """to_dense_batch/from_dense_batch at zinc.json's bound (40 slots; the
    packed bin's padding graph holds hundreds of padding nodes, most past
    the bound) and segment_min with ties, forward and gradient, on the
    card against the CPU."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.dense import from_dense_batch, to_dense_batch
    from hydragnn_tpu_torch.ops.segment import segment_min

    batch = _zinc_bin()
    assert int(batch.node_slot.max()) >= 40
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(batch.num_nodes, 64, generator=gen)
    w = torch.randn(batch.num_graphs, 40, 64, generator=gen)
    h = torch.randn(batch.num_edges, 8, generator=gen)
    h[1] = h[0]  # a tie into one receiver (edges are receiver-sorted)
    assert batch.receivers[1] == batch.receivers[0]
    cot = torch.randn(batch.num_nodes, 8, generator=gen)
    res = {}
    for dev in ("cuda", "cpu"):
        b = batch.to(dev)
        xx = x.to(dev).requires_grad_(True)
        hh = h.to(dev).requires_grad_(True)
        dense, mask = to_dense_batch(xx, b, 40)
        back = from_dense_batch(dense * w.to(dev), b, 40)
        mn = segment_min(hh, b.receivers, b.num_nodes, mask=b.edge_mask)
        ((back * back).sum() + (mn * cot.to(dev)).sum()).backward()
        res[dev] = [t.detach().cpu() for t in (dense, mask, back, mn, xx.grad, hh.grad)]
    for name, x_, y_ in zip(("dense", "mask", "back", "min", "d_x", "d_h"),
                            res["cuda"], res["cpu"]):
        torch.testing.assert_close(x_, y_, rtol=1e-5, atol=1e-5, msg=name)


OPTIMIZERS = ("SGD", "Adam", "AdamW", "Adadelta", "Adagrad", "Adamax", "RMSprop",
              "LAMB", "FusedLAMB")


def _capture_case(torch, optimizer="AdamW", n_batches=6, seed=0, device="cuda"):
    """A small SchNet (2 CFConv layers, hidden 16, 16 filters, 16
    Gaussians) on the card with its optimizer, and ``n_batches`` planned
    host batches of 8 qm9-like requests, all padded to one shape."""
    from hydragnn_tpu_torch.data.graph import PadSpec, collate
    from hydragnn_tpu_torch.models import spec
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serve.loadgen import synthetic_request_samples
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    samples = synthetic_request_samples("qm9", 8 * n_batches, seed=seed)
    groups = [samples[i:i + 8] for i in range(0, len(samples), 8)]
    pad = PadSpec(
        num_nodes=max(sum(s.num_nodes for s in g) for g in groups) + 8,
        num_edges=max(sum(s.num_edges for s in g) for g in groups) + 8,
        num_graphs=9,
    )
    batches = [collate(g, pad, with_segment_plan=True) for g in groups]
    cfg = spec.ModelConfig(
        mpnn_type="SchNet", input_dim=1, hidden_dim=16, num_conv_layers=2,
        heads=(spec.HeadSpec(name="energy", type="graph", dim=1),), task_weights=(1.0,),
        graph_branches=(spec.BranchSpec(name="branch-0", num_sharedlayers=2,
                                        dim_sharedlayers=16, num_headlayers=2,
                                        dim_headlayers=(16, 16)),),
        radius=4.0, max_neighbours=32, num_gaussians=16, num_filters=16,
    )
    model = create_model(cfg, device, seed=seed)
    opt = select_optimizer(model.parameters(),
                           {"Optimizer": {"type": optimizer, "learning_rate": 0.01}})
    return model, cfg, opt, batches


def _supersteps(torch, model, cfg, opt, graphs):
    from hydragnn_tpu_torch.train.loop import make_superstep_fn

    kw = dict(device=torch.device("cuda"), graphs=graphs)
    return (make_superstep_fn(model, opt, cfg, train=True, **kw),
            make_superstep_fn(model, None, cfg, train=False, **kw))


def _state_equal(torch, m1, o1, m2, o2):
    for (n, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), n
    for s1, s2 in zip(o1.state.values(), o2.state.values()):
        for k in s1:
            assert torch.equal(s1[k], s2[k]), k
    for g1, g2 in zip(o1.param_groups, o2.param_groups):
        assert torch.equal(g1["step"], g2["step"]) and torch.equal(g1["lr"], g2["lr"])


@pytest.mark.cuda
def test_replayed_steps_equal_eager():
    """Four SchNet train steps and two eval steps through the graph cache
    (eager, capture and replay, replays) equal four eager steps bit for
    bit: parameters, optimizer state, loss sums. K1 and K2 count the
    replays' launches (2 a forward, 2 a train step) as eager steps
    would."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.state import TrainState

    results = {}
    for mode in ("eager", "graphs"):
        model, cfg, opt, batches = _capture_case(torch)
        graphs = StepGraphs("cuda") if mode == "graphs" else None
        train, evaluate = _supersteps(torch, model, cfg, opt, graphs)
        state = TrainState(model, opt, graphs=graphs)
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        acc = None
        for b in batches[:4]:
            state, acc = train(state, acc, [b])
        ev = None
        for b in batches[4:] + batches[4:]:
            ev = evaluate(state, ev, [b])
        torch.cuda.synchronize()
        launches = (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2)
        assert launches == (2 * 8, 2 * 4), (mode, launches)
        results[mode] = (model, opt, acc, ev, graphs)
    (m1, o1, a1, e1, _), (m2, o2, a2, e2, graphs) = results["eager"], results["graphs"]
    assert (graphs.eager_runs, graphs.captures, graphs.replays) == (2, 2, 6)
    _state_equal(torch, m1, o1, m2, o2)
    for x, y in zip(a1 + e1, a2 + e2):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_k_step_replay_equals_single_replays():
    """Six steps as K = 2 groups (eager, capture and replay, replay) equal
    six single steps through the cache bit for bit."""
    torch = _need_card()
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.state import TrainState

    runs = []
    for k in (1, 2):
        model, cfg, opt, batches = _capture_case(torch)
        graphs = StepGraphs("cuda")
        train, _ = _supersteps(torch, model, cfg, opt, graphs)
        state, acc = TrainState(model, opt, graphs=graphs), None
        for i in range(0, 6, k):
            state, acc = train(state, acc, batches[i:i + k])
        torch.cuda.synchronize()
        assert state.step == 6 and graphs.captures == 1
        runs.append((model, opt, acc))
    _state_equal(torch, runs[0][0], runs[0][1], runs[1][0], runs[1][1])
    for x, y in zip(runs[0][2], runs[1][2]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_collector_off_inside_captures():
    """Python's cyclic collector is off while a train step or a rollout
    macro is captured, and on again after; the replays stay right. (A
    collection inside a capture may destroy a dead graph, which
    invalidates the capture in global mode.)"""
    import gc

    torch = _need_card()
    from hydragnn_tpu_torch.simulate import RolloutEngine, md_template_batch, simulation_settings
    from hydragnn_tpu_torch.train.capture import StepGraphs

    seen = []

    def watched(fn):
        def run(*args):
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
            return fn(*args)
        return run

    assert gc.isenabled()
    _, _, _, batches = _capture_case(torch, n_batches=3)
    graphs = StepGraphs("cuda")
    step = watched(lambda views: (views[0].pos * 2.0,))
    outs = [graphs.run(("doubled",), step, [b])[0].clone() for b in batches]
    torch.cuda.synchronize()
    assert (graphs.eager_runs, graphs.captures, graphs.replays) == (1, 1, 2)
    for b, out in zip(batches, outs):
        assert torch.equal(out.cpu(), torch.as_tensor(b.pos) * 2.0)

    model, cfg, samples = _painn_serving(torch)
    smp = samples[0]
    s = simulation_settings({"Simulation": {
        "steps": 12, "superstep_k": 4, "dt": 2e-3, "temperature_k": 0.0,
        "neighbor": {"skin": 0.05, "max_edges": 256}}})
    eng = RolloutEngine(model, None, cfg, md_template_batch(smp.x, smp.pos, 256), s)
    eng._macro = watched(eng._macro)
    res = eng.run(eng.init_state())
    assert eng.graph_stats()["captures"] == 1 and np.isfinite(res.energies).all()
    assert seen == [False, False] and gc.isenabled()


@pytest.mark.cuda
def test_guarded_replayed_steps_equal_eager():
    """The divergence guard's train step (``guard=True``) through the
    graph cache equals it eager and the unguarded replayed step, bit for
    bit, over four steps: parameters, optimizer state, loss sums; every
    step's predicate true and the device step counter at 4."""
    torch = _need_card()
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.state import TrainState

    runs = {}
    for mode, guard in (("eager", True), ("graphs", True), ("unguarded", False)):
        model, cfg, opt, batches = _capture_case(torch)
        graphs = None if mode == "eager" else StepGraphs("cuda")
        train = make_superstep_fn(model, opt, cfg, device=torch.device("cuda"),
                                  graphs=graphs, guard=guard)
        state, acc, oks = TrainState(model, opt, graphs=graphs), None, []
        for b in batches[:4]:
            out = train(state, acc, [b])
            state, acc = out[:2]
            oks += out[2].tolist() if guard else []
        torch.cuda.synchronize()
        assert int(state.step_t) == 4 and (not guard or oks == [True] * 4), (mode, oks)
        runs[mode] = (model, opt, acc)
    for other in ("graphs", "unguarded"):
        _state_equal(torch, runs["eager"][0], runs["eager"][1], runs[other][0], runs[other][1])
        for x, y in zip(runs["eager"][2], runs[other][2]):
            assert torch.equal(x, y), other


@pytest.mark.cuda
def test_poisoned_step_inside_captured_superstep_is_skipped():
    """``nan:loss@5`` armed, guarded K = 2 graphs (eager, capture, then
    replays: step 5 falls inside a replayed graph): equal bit for bit to
    single replayed steps that never take step 5, with step 5's predicate
    false."""
    torch = _need_card()
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.state import TrainState
    from hydragnn_tpu_torch.utils import faults

    def run(k, guard, skip=None):
        model, cfg, opt, batches = _capture_case(torch, n_batches=8)
        graphs = StepGraphs("cuda")
        train = make_superstep_fn(model, opt, cfg, device=torch.device("cuda"),
                                  graphs=graphs, guard=guard)
        state, acc, oks = TrainState(model, opt, graphs=graphs), None, []
        for i in range(0, 8, k):
            if i == skip:
                state.step += 1
                state.step_t += 1
                continue
            out = train(state, acc, batches[i:i + k])
            state, acc = out[:2]
            oks += out[2].tolist() if guard else []
        torch.cuda.synchronize()
        return model, opt, acc, oks, graphs

    faults.install("nan:loss@5")
    try:
        model, opt, acc, oks, graphs = run(2, True)
    finally:
        faults.reset()
    assert oks == [True] * 5 + [False] + [True] * 2 and graphs.replays == 3
    base = run(1, False, skip=5)
    _state_equal(torch, model, opt, base[0], base[1])
    for x, y in zip(acc, base[2]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", OPTIMIZERS)
def test_optimizer_captured_step_equals_eager(kind):
    """Each optimizer's replayed step equals its eager step bit for bit,
    with a learning-rate change before the third step that the replay
    reads from the device tensor (no recapture)."""
    torch = _need_card()
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.optimizer import set_learning_rate
    from hydragnn_tpu_torch.train.state import TrainState

    runs = []
    for graphs in (None, StepGraphs("cuda")):
        model, cfg, opt, batches = _capture_case(torch, kind)
        train, _ = _supersteps(torch, model, cfg, opt, graphs)
        state, acc = TrainState(model, opt, graphs=graphs), None
        for i in range(4):
            if i == 2:
                set_learning_rate(opt, 0.002)
            state, acc = train(state, acc, [batches[i]])
        torch.cuda.synchronize()
        runs.append((model, opt, acc))
        if graphs is not None:
            assert graphs.captures == 1 and graphs.replays == 3
    assert all(torch.isfinite(p).all() for p in runs[1][0].parameters())
    _state_equal(torch, runs[0][0], runs[0][1], runs[1][0], runs[1][1])


def _mace_case(torch, n_batches=3, seed=0, device="cuda"):
    """oc20.json's MACE at full width (hidden 32, 2 layers, max_ell 2,
    node_max_ell 2, correlation 2, num_radial 8; energy + 25 x force
    loss) on the card, with ``n_batches`` planned batches of 6 periodic
    crystals each (simple-cubic cells of 2-3 lattice constants of 3.2,
    cutoff 5.0, so several images of one pair), all padded to one
    shape."""
    from hydragnn_tpu_torch.data.graph import GraphSample, PadSpec, collate
    from hydragnn_tpu_torch.models import spec
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.neighbors import radius_graph_pbc
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(6 * n_batches):
        cells = rng.integers(2, 4, 3)
        grid = np.stack(np.meshgrid(*(np.arange(c) * 3.2 for c in cells), indexing="ij"),
                        axis=-1).reshape(-1, 3)
        pos = grid + rng.normal(scale=0.2, size=grid.shape)
        cell = np.diag(cells * 3.2)
        ei, shifts = radius_graph_pbc(pos, cell, 5.0)
        samples.append(GraphSample(
            x=rng.choice([13.0, 22.0, 28.0, 41.0], (len(pos), 1)).astype(np.float32),
            pos=pos.astype(np.float32), edge_index=ei, edge_shifts=shifts.astype(np.float32),
            cell=cell.astype(np.float32), energy=float(rng.normal()),
            forces=rng.normal(size=pos.shape).astype(np.float32)))
    groups = [samples[i:i + 6] for i in range(0, len(samples), 6)]
    pad = PadSpec(num_nodes=max(sum(s.num_nodes for s in g) for g in groups) + 8,
                  num_edges=max(sum(s.num_edges for s in g) for g in groups) + 64,
                  num_graphs=7)
    batches = [collate(g, pad, with_segment_plan=True) for g in groups]
    cfg = spec.ModelConfig(
        mpnn_type="MACE", input_dim=1, hidden_dim=32, num_conv_layers=2,
        heads=(spec.HeadSpec("energy", "graph", 1),), task_weights=(1.0,),
        graph_branches=(spec.BranchSpec(num_sharedlayers=1, dim_sharedlayers=32,
                                        num_headlayers=2, dim_headlayers=(32, 32)),),
        radius=5.0, num_radial=8, max_ell=2, node_max_ell=2, correlation=2,
        avg_num_neighbors=20.0, graph_pooling="add", enable_interatomic_potential=True,
        energy_weight=1.0, force_weight=25.0,
    )
    model = create_model(cfg, device, seed=seed)
    opt = select_optimizer(model.parameters(),
                           {"Optimizer": {"type": "AdamW", "learning_rate": 0.002}})
    return model, cfg, opt, batches


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_kernels_mace_width(dt):
    """K1 and K2 in the reduce-only flavour at MACE's receiver-sum width
    (F = 288: [C = 32] x [(lmax + 1)^2 = 9]) on a periodic MACE batch's
    plan: each equals its plain version (same bits on two runs), K2 zero
    off the plan."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a_dt = getattr(torch, dt)
    batch = _mace_case(torch, n_batches=1)[3][0].to("cuda")
    n, e, f = batch.num_nodes, batch.num_edges, 288
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window, n)
    gen = torch.Generator().manual_seed(288)
    a = torch.randn(e, f, generator=gen).to("cuda", a_dt)
    g = torch.randn(n, f, generator=gen).to("cuda", a_dt)
    with torch.no_grad():
        got = edge_pipeline_planned(a, None, None, *plan)
        again = edge_pipeline_planned(a, None, None, *plan)
        ref = edge_pipeline_plain(a, None, None, *plan)
    d_a, d_b, d_w = edge_pipeline_bwd_planned(g, a, None, None, *plan)
    d_a2 = edge_pipeline_bwd_planned(g, a, None, None, *plan)[0]
    d_ref = edge_pipeline_bwd_plain(g, a, None, None, *plan)[0]
    torch.cuda.synchronize()
    assert got.shape == (n, f) and got.dtype == a_dt and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dt])
    assert d_b is None and d_w is None and torch.equal(d_a, d_a2)
    torch.testing.assert_close(d_a.float(), d_ref.float(), **VJP_TOL[dt])
    covered = torch.zeros(e, dtype=torch.bool, device="cuda")
    covered[batch.seg_perm[batch.seg_valid].long()] = True
    assert not d_a[~covered].any()


@pytest.mark.cuda
def test_mace_replayed_mlip_step_equals_eager():
    """Three MACE MLIP train steps through the graph cache (eager,
    capture and replay, replay) equal three eager steps bit for bit
    (parameters, optimizer state, loss sums): every sum in the step is
    K1/K2, a one-hot matmul or a gather's sorted backward. K1 and K2
    count 4 launches each per step, replays included."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.state import TrainState

    results = {}
    for mode in ("eager", "graphs"):
        model, cfg, opt, batches = _mace_case(torch)
        graphs = StepGraphs("cuda") if mode == "graphs" else None
        train = make_superstep_fn(model, opt, cfg, compute_grad_energy=True,
                                  device=torch.device("cuda"), graphs=graphs)
        state, acc = TrainState(model, opt, graphs=graphs), None
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        for b in batches:
            state, acc = train(state, acc, [b])
        torch.cuda.synchronize()
        launches = (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2)
        assert launches == (4 * 3, 4 * 3), (mode, launches)
        assert all(torch.isfinite(p).all() for p in model.parameters())
        results[mode] = (model, opt, acc, graphs)
    (m1, o1, a1, _), (m2, o2, a2, graphs) = results["eager"], results["graphs"]
    assert (graphs.eager_runs, graphs.captures, graphs.replays) == (1, 1, 2)
    _state_equal(torch, m1, o1, m2, o2)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)


def _pnaeq_case(torch, n_batches=3, seed=0, device="cuda"):
    """md17.json's PNAEq potential at full width (hidden 64, 3 layers,
    num_radial 20, radius 4.0; energy + 10 x force loss) on the card,
    with ``n_batches`` planned batches of 8 random molecules of 17-23
    atoms (radius graph 4.0, 24 neighbours), all padded to one shape."""
    from hydragnn_tpu_torch.config.config import gather_deg
    from hydragnn_tpu_torch.data.graph import GraphSample, PadSpec, collate
    from hydragnn_tpu_torch.models import spec
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.ops.neighbors import radius_graph
    from hydragnn_tpu_torch.train.optimizer import select_optimizer

    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(8 * n_batches):
        n = int(rng.integers(17, 24))
        pos = rng.uniform(0, 2.2 * n ** (1 / 3), (n, 3)).astype(np.float32)
        samples.append(GraphSample(
            x=rng.choice([1.0, 6.0, 8.0], (n, 1)).astype(np.float32), pos=pos,
            edge_index=radius_graph(pos, 4.0, max_neighbours=24),
            energy=float(rng.normal()), forces=rng.normal(size=pos.shape).astype(np.float32)))
    groups = [samples[i:i + 8] for i in range(0, len(samples), 8)]
    pad = PadSpec(num_nodes=max(sum(s.num_nodes for s in g) for g in groups) + 8,
                  num_edges=max(sum(s.num_edges for s in g) for g in groups) + 64,
                  num_graphs=9)
    batches = [collate(g, pad, with_segment_plan=True) for g in groups]
    deg = tuple(int(v) for v in gather_deg(samples))
    cfg = spec.ModelConfig(
        mpnn_type="PNAEq", input_dim=1, hidden_dim=64, num_conv_layers=3,
        heads=(spec.HeadSpec("energy", "graph", 1),), task_weights=(1.0,),
        graph_branches=(spec.BranchSpec(num_sharedlayers=1, dim_sharedlayers=64,
                                        num_headlayers=2, dim_headlayers=(64, 64)),),
        radius=4.0, num_radial=20, pna_deg=deg, max_neighbours=len(deg) - 1,
        graph_pooling="add", enable_interatomic_potential=True, energy_weight=1.0,
        force_weight=10.0,
    )
    model = create_model(cfg, device, seed=seed)
    opt = select_optimizer(model.parameters(),
                           {"Optimizer": {"type": "AdamW", "learning_rate": 0.002}})
    return model, cfg, opt, batches


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 3, 128, 192])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_kernels_pnaeq_widths(f, dt):
    """K1 and K2 in the reduce-only flavour at PNAEq's receiver-sum
    widths (layer 0's moment pass 2 and vector sum 3 at the input width
    1; then 2F = 128 and 3F = 192 at hidden 64) on a PNAEq batch's plan:
    each equals its plain version (same bits on two runs), K2 zero off
    the plan."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    a_dt = getattr(torch, dt)
    batch = _pnaeq_case(torch, n_batches=1)[3][0].to("cuda")
    n, e = batch.num_nodes, batch.num_edges
    plan = (batch.seg_perm, batch.seg_ids, batch.seg_valid, batch.seg_window, n)
    gen = torch.Generator().manual_seed(f)
    a = torch.randn(e, f, generator=gen).to("cuda", a_dt)
    g = torch.randn(n, f, generator=gen).to("cuda", a_dt)
    with torch.no_grad():
        got = edge_pipeline_planned(a, None, None, *plan)
        again = edge_pipeline_planned(a, None, None, *plan)
        ref = edge_pipeline_plain(a, None, None, *plan)
    d_a, d_b, d_w = edge_pipeline_bwd_planned(g, a, None, None, *plan)
    d_a2 = edge_pipeline_bwd_planned(g, a, None, None, *plan)[0]
    d_ref = edge_pipeline_bwd_plain(g, a, None, None, *plan)[0]
    torch.cuda.synchronize()
    assert got.shape == (n, f) and got.dtype == a_dt and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dt])
    assert d_b is None and d_w is None and torch.equal(d_a, d_a2)
    torch.testing.assert_close(d_a.float(), d_ref.float(), **VJP_TOL[dt])
    covered = torch.zeros(e, dtype=torch.bool, device="cuda")
    covered[batch.seg_perm[batch.seg_valid].long()] = True
    assert not d_a[~covered].any()


@pytest.mark.cuda
def test_pnaeq_replayed_mlip_step_equals_eager():
    """Three PNAEq MLIP train steps through the graph cache (eager,
    capture and replay, replay) against three eager steps: 12 K1 and 12
    K2 launches per step (two receiver sums a layer: 6 K1 forward, 6 K2
    in the force pass, 6 of each in the loss's backward), replays
    included; the same parameters, optimizer state and loss sums bit for
    bit (PNA's min is order-free and its degree an exact count)."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.loop import make_superstep_fn
    from hydragnn_tpu_torch.train.state import TrainState

    results = {}
    for mode in ("eager", "graphs"):
        model, cfg, opt, batches = _pnaeq_case(torch)
        graphs = StepGraphs("cuda") if mode == "graphs" else None
        train = make_superstep_fn(model, opt, cfg, compute_grad_energy=True,
                                  device=torch.device("cuda"), graphs=graphs)
        state, acc = TrainState(model, opt, graphs=graphs), None
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        for b in batches:
            state, acc = train(state, acc, [b])
        torch.cuda.synchronize()
        launches = (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2)
        assert launches == (12 * 3, 12 * 3), (mode, launches)
        assert all(torch.isfinite(p).all() for p in model.parameters())
        results[mode] = (model, opt, acc, graphs)
    (m1, o1, a1, _), (m2, o2, a2, graphs) = results["eager"], results["graphs"]
    assert (graphs.eager_runs, graphs.captures, graphs.replays) == (1, 1, 2)
    _state_equal(torch, m1, o1, m2, o2)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)


def _nccl_world_one(torch, tmp_path):
    """A one-rank NCCL process group (destroyed by the caller)."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    from hydragnn_tpu_torch.parallel.runtime import plan_from_config

    return plan_from_config({"NeuralNetwork": {"Training": {"Parallelism": {"scheme": "dp"}}}})


@pytest.mark.cuda
def test_nccl_world_one_dp_step_equals_single(tmp_path):
    """At world 1 over NCCL the dp train step (the count and flat
    gradient all-reduces, the weight n/n = 1) equals the single scheme's
    step bit for bit: parameters, optimizer state, loss sums."""
    torch = _need_card()
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel.dp import make_dp_superstep_fn
    from hydragnn_tpu_torch.train.state import TrainState

    plan = _nccl_world_one(torch, tmp_path)
    try:
        results = []
        for scheme in ("single", "dp"):
            model, cfg, opt, batches = _capture_case(torch, n_batches=2)
            if scheme == "dp":
                train = make_dp_superstep_fn(model, opt, cfg, plan, device=torch.device("cuda"))
            else:
                train = _supersteps(torch, model, cfg, opt, None)[0]
            state, acc = TrainState(model, opt), None
            for b in batches:
                state, acc = train(state, acc, [b])
            torch.cuda.synchronize()
            results.append((model, opt, acc))
    finally:
        dist.destroy_process_group()
    (m1, o1, a1), (m2, o2, a2) = results
    _state_equal(torch, m1, o1, m2, o2)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dp", "multibranch"])
def test_nccl_dp_replay_equals_eager(tmp_path, kind):
    """Four dp train steps through the graph cache (eager, capture and
    replay, replays; the NCCL all-reduces inside the graph) equal four
    eager dp steps bit for bit, and K1/K2 count the replays' launches.
    The multibranch step (the equal mean over slots, the D / D_b decoder
    rescale, the dual optimizer clipped per group) is captured alike."""
    torch = _need_card()
    import dataclasses

    import torch.distributed as dist

    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.parallel.dp import capturable, make_dp_superstep_fn
    from hydragnn_tpu_torch.parallel.multibranch import decoder_grad_scales, dual_optimizer
    from hydragnn_tpu_torch.parallel.runtime import plan_from_config
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.state import TrainState

    plan = _nccl_world_one(torch, tmp_path)
    try:
        if kind == "multibranch":
            plan = dataclasses.replace(plan_from_config({"NeuralNetwork": {"Training": {
                "Parallelism": {"scheme": "multibranch"}}}}), devices_per_branch=(1,))
        assert capturable(plan)
        results = {}
        for mode in ("eager", "graphs"):
            model, cfg, opt, batches = _capture_case(torch)
            kw = {}
            if kind == "multibranch":
                opt = dual_optimizer(model, {"Optimizer": {"type": "AdamW",
                                                           "learning_rate": 0.01}})
                kw = dict(kind=kind, decoder_scales=decoder_grad_scales(model, cfg, 1, (1,)),
                          clip_norm=1.0)
                assert kw["decoder_scales"], "no decoder parameter found for branch-0"
            graphs = StepGraphs("cuda") if mode == "graphs" else None
            train = make_dp_superstep_fn(model, opt, cfg, plan, device=torch.device("cuda"),
                                         graphs=graphs, **kw)
            state, acc = TrainState(model, opt, graphs=graphs), None
            k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
            for b in batches[:4]:
                state, acc = train(state, acc, [b])
            torch.cuda.synchronize()
            assert (edge_pipeline_planned.launches - k1,
                    edge_pipeline_bwd_planned.launches - k2) == (2 * 4, 2 * 4), mode
            results[mode] = (model, opt, acc, graphs)
    finally:
        dist.destroy_process_group()
    (m1, o1, a1, _), (m2, o2, a2, graphs) = results["eager"], results["graphs"]
    assert (graphs.eager_runs, graphs.captures, graphs.replays) == (1, 1, 3)
    _state_equal(torch, m1, o1, m2, o2)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)


def _state_tensors(model, opt):
    """Every tensor a train step writes, cloned."""
    return [t.clone() for t in list(model.state_dict().values()) + [
        v for s in opt.state.values() for v in s.values()] + [
        g[k] for g in opt.param_groups for k in ("step", "lr")]]


@pytest.mark.cuda
def test_nccl_multibranch_guarded_step_on_card(tmp_path):
    """The multibranch guard on the card (world 1 over NCCL, the dual
    optimizer clipped per group): four guarded steps, eager and through
    the graph cache, equal four unguarded ones bit for bit with every
    slot's predicate true ([branch-0, encoder]); then a replayed guarded
    step on a batch with NaN labels reads both slots bad and leaves every
    tensor of the state as it was. K1/K2 count 2 a step."""
    torch = _need_card()
    import dataclasses

    import torch.distributed as dist

    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.parallel.dp import make_dp_superstep_fn
    from hydragnn_tpu_torch.parallel.multibranch import (
        decoder_grad_scales,
        dual_optimizer,
        guard_slots,
    )
    from hydragnn_tpu_torch.parallel.runtime import plan_from_config
    from hydragnn_tpu_torch.train.capture import StepGraphs
    from hydragnn_tpu_torch.train.state import TrainState

    _nccl_world_one(torch, tmp_path)
    try:
        plan = dataclasses.replace(plan_from_config({"NeuralNetwork": {"Training": {
            "Parallelism": {"scheme": "multibranch"}}}}), devices_per_branch=(1,))
        results = {}
        for mode in ("eager", "graphs"):
            for guard in (False, True):
                model, cfg, opt, batches = _capture_case(torch)
                opt = dual_optimizer(model, {"Optimizer": {"type": "AdamW",
                                                           "learning_rate": 0.01}})
                graphs = StepGraphs("cuda") if mode == "graphs" else None
                train = make_dp_superstep_fn(
                    model, opt, cfg, plan, device=torch.device("cuda"), graphs=graphs,
                    kind="multibranch", decoder_scales=decoder_grad_scales(model, cfg, 1, (1,)),
                    clip_norm=1.0, guard=guard,
                    slots=guard_slots(model, cfg, 1) if guard else None)
                state, acc, oks = TrainState(model, opt, graphs=graphs), None, []
                k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
                for b in batches[:4]:
                    out = train(state, acc, [b])
                    state, acc = out[:2]
                    if guard:
                        oks.append(out[2].cpu().tolist())
                torch.cuda.synchronize()
                assert (edge_pipeline_planned.launches - k1,
                        edge_pipeline_bwd_planned.launches - k2) == (2 * 4, 2 * 4)
                results[mode, guard] = (model, opt, acc, oks, train, state, batches)
        for mode in ("eager", "graphs"):
            (m1, o1, a1, *_), (m2, o2, a2, oks, *_) = results[mode, False], results[mode, True]
            assert oks == [[[True, True]]] * 4, (mode, oks)
            _state_equal(torch, m1, o1, m2, o2)
            for x, y in zip(a1, a2):
                assert torch.equal(x, y)
        model, opt, acc, _, train, state, batches = results["graphs", True]
        before = _state_tensors(model, opt)
        poisoned = batches[4]
        y = np.array(poisoned.y_graph, copy=True)
        y[np.asarray(poisoned.graph_mask)] = np.nan
        out = train(state, acc, [dataclasses.replace(poisoned, y_graph=y)])
        torch.cuda.synchronize()
        assert out[2].cpu().tolist() == [[False, False]]
        assert all(torch.equal(a, b) for a, b in zip(before, _state_tensors(model, opt)))
        assert state.graphs.replays > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("stages", ["a", "ab", "aw", "abw"])
def test_dispatcher_ops_match_plain(stages):
    """K1's and K2's operators (``torch.ops.hydragnn.*``) on the card:
    each call launches its kernel once, equals the plain version at the
    fused kernels' tolerances, returns an empty tensor for the gradient
    of an absent operand, and its fake implementation gives the real
    output's shapes and types."""
    torch = _need_card()
    from torch._subclasses.fake_tensor import FakeTensorMode

    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_plain,
        edge_pipeline_bwd_planned,
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    e_real, e_pad, n, f = SHAPES[0]
    a, b, w, *plan = _case(torch, 5, e_real, e_pad, n, f, f, torch.float32)
    b = b if "b" in stages else None
    w = w if "w" in stages else None
    g = torch.randn(n, f, device="cuda")
    k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
    out = torch.ops.hydragnn.edge_pipeline(a, b, w, *plan, n, 32, 64)
    grads = torch.ops.hydragnn.edge_pipeline_bwd(g, a, b, w, *plan, n, 32, 64)
    torch.cuda.synchronize()
    assert (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2) == (1, 1)
    torch.testing.assert_close(out, edge_pipeline_plain(a, b, w, *plan, n), **TOL["float32"])
    refs = edge_pipeline_bwd_plain(g, a, b, w, *plan, n)
    for got, ref in zip(grads, refs):
        if ref is None:
            assert got.numel() == 0
        else:
            torch.testing.assert_close(got, ref, **VJP_TOL["float32"])
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fa, fb, fw, fg = (None if t is None else mode.from_tensor(t) for t in (a, b, w, g))
        fplan = [mode.from_tensor(p) for p in plan]
        fout = torch.ops.hydragnn.edge_pipeline(fa, fb, fw, *fplan, n, 32, 64)
        fgrads = torch.ops.hydragnn.edge_pipeline_bwd(fg, fa, fb, fw, *fplan, n, 32, 64)
    assert (fout.shape, fout.dtype) == (out.shape, out.dtype)
    assert [(x.shape, x.dtype) for x in fgrads] == [(x.shape, x.dtype) for x in grads]


def _painn_serving(torch):
    """A small PaiNN potential (graph energy head, sum pooling) and
    twelve molecules with positions."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.models.spec import BranchSpec, HeadSpec, ModelConfig
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    cfg = ModelConfig(
        mpnn_type="PAINN", input_dim=1, hidden_dim=32, num_conv_layers=3,
        heads=(HeadSpec("energy", "graph", 1),), graph_branches=(BranchSpec(),),
        node_branches=(BranchSpec(),), task_weights=(1.0,), radius=2.5,
        num_radial=6, graph_pooling="add", enable_interatomic_potential=True,
    )
    rng = np.random.default_rng(3)
    samples = []
    for _ in range(12):
        k = int(rng.integers(6, 14))
        pos = rng.uniform(0, 3.0, (k, 3)).astype(np.float32)
        samples.append(GraphSample(
            x=rng.integers(1, 10, (k, 1)).astype(np.float32), pos=pos,
            edge_index=radius_graph(pos, 2.5, max_neighbours=16)))
    return create_model(cfg, "cuda", seed=1), cfg, samples


@pytest.mark.cuda
def test_served_forces_and_exported_mlip_on_card():
    """A ``with_forces`` engine on the card: 6 K1 and 6 K2 launches a
    bin (PaiNN's two receiver sums a layer, forward and force pass), served
    energies and forces equal a direct ``energy_and_forces`` at the bin
    bit for bit, and an engine serving the exported MLIP artifact equals
    the live one bit for bit."""
    torch = _need_card()
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.export import export_inference
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
    from hydragnn_tpu_torch.serve.engine import (
        ServingEngine,
        ServingSettings,
        fit_serving_budgets,
    )
    from hydragnn_tpu_torch.train.mlip import energy_and_forces

    model, cfg, samples = _painn_serving(torch)
    st = ServingSettings(enabled=True, batch_size=4)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), st)
    live = ServingEngine(model, cfg, None, budgets, example=samples[0], settings=st,
                         with_forces=True, device="cuda")
    arts = {(b.num_nodes, b.num_edges, b.num_graphs): export_inference(
        model, cfg, None, live.collate_bin([samples[0]], b), with_forces=True,
        devices=["cuda"]) for b in budgets}
    offline = ServingEngine(model, cfg, None, budgets, example=samples[0], settings=st,
                            with_forces=True, warm=False, device="cuda")
    offline.install_executables(ServingEngine.from_exported(arts, device="cuda"))
    served = []
    for eng in (live, offline):
        bat = DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
        reqs = [bat.submit(s) for s in samples]
        bat.close()
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        records = eng.process(bat)
        torch.cuda.synchronize()
        assert edge_pipeline_planned.launches - k1 == 2 * 3 * len(records)
        assert edge_pipeline_bwd_planned.launches - k2 == 2 * 3 * len(records)
        served.append((reqs, records))
    (reqs, records), (reqs2, _) = served
    for rec in records:
        batch = live.collate_bin([q.sample for q in rec["reqs"]], rec["spec"]).to("cuda")
        ge, forces = energy_and_forces(live.model, batch, cfg, create_graph=False)
        ge, forces = ge.detach().cpu().numpy(), forces.cpu().numpy()
        for gi, q in enumerate(rec["reqs"]):
            off, n = rec["offsets"][gi]
            np.testing.assert_array_equal(q.result[0], ge[gi])
            np.testing.assert_array_equal(q.result[1], forces[off:off + n])
    for a, b in zip(reqs, reqs2):
        for x, y in zip(a.result, b.result):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
def test_rollover_captures_while_replicas_serve():
    """A two-replica tier on the card rolls over while a stream is served:
    the shadow engines capture their graphs while the old ones replay and
    fetch (``GRAPH_LOCK``, captures in torch's global mode, which fails
    on any CUDA call another thread makes meanwhile); every request is
    served, the
    outputs equal across the swap bit for bit (same snapshot), and a NaN
    snapshot is refused with the old outputs unchanged."""
    import threading
    import time

    torch = _need_card()
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve.admission import AdmissionError
    from hydragnn_tpu_torch.serve.engine import ServingSettings, fit_serving_budgets
    from hydragnn_tpu_torch.serve.fleet import FleetSettings, ServingTier
    from hydragnn_tpu_torch.serve.loadgen import _tiny_serving_model, synthetic_request_samples

    samples = synthetic_request_samples("qm9", 64, seed=5)
    st = ServingSettings(enabled=True, deadline_ms=15.0, max_open_bins=2, batch_size=4)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), st)
    model, cfg, _ = _tiny_serving_model("cuda")
    tier = ServingTier(model, cfg, None, budgets, example=samples[0], settings=st,
                       fleet=FleetSettings(replicas=2), device="cuda")

    def probe(batch):
        out = []
        for s in batch:
            fr = tier.submit(s)
            t0 = time.monotonic()
            while not fr.done:
                assert time.monotonic() - t0 < 20.0
                time.sleep(0.002)
            out.append(np.asarray(fr.result[0]).copy())
        return out

    try:
        before = probe(samples[:8])
        stream = []

        def drive():
            for s in samples[8:48]:
                stream.append(tier.submit(s))
                time.sleep(0.004)

        feeder = threading.Thread(target=drive, daemon=True)
        feeder.start()
        time.sleep(0.02)
        row = tier.rollover(model.state_dict())
        feeder.join(timeout=60)
        t0 = time.monotonic()
        while not all(r.done for r in stream):
            assert time.monotonic() - t0 < 30.0
            time.sleep(0.005)
        assert row["drained"] and len(stream) == 40
        assert all(r.result is not None for r in stream)
        for a, b in zip(before, probe(samples[:8])):
            np.testing.assert_array_equal(a, b)
        bad = {k: torch.full_like(v, float("nan")) if v.is_floating_point() else v
               for k, v in model.state_dict().items()}
        with pytest.raises(AdmissionError):
            tier.rollover(bad)
        assert tier.rollovers == 1
        for a, b in zip(before, probe(samples[:8])):
            np.testing.assert_array_equal(a, b)
    finally:
        tier.close()


def _tiny_engine_case(torch):
    from hydragnn_tpu_torch.data.padschedule import dataset_size_arrays
    from hydragnn_tpu_torch.serve.engine import ServingSettings, fit_serving_budgets
    from hydragnn_tpu_torch.serve.loadgen import _tiny_serving_model, synthetic_request_samples

    samples = synthetic_request_samples("qm9", 24, seed=6)
    st = ServingSettings(enabled=True, batch_size=4)
    budgets = fit_serving_budgets(*dataset_size_arrays(samples), st)
    model, cfg, _ = _tiny_serving_model("cuda")
    return model, cfg, samples, st, budgets


def _serve_all(eng, samples, budgets):
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher

    bat = DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
    reqs = [bat.submit(s) for s in samples]
    bat.close()
    eng.process(bat)
    return [r.result for r in reqs]


@pytest.mark.cuda
def test_install_releases_replaced_and_failed_graphs():
    """Each install on the card keeps one graph a budget and releases the
    graphs it replaces, so repeated installs hold the device memory
    steady; an install whose last warm-up fails releases the graphs it
    had captured and leaves the engine's graphs, counts, memory and
    outputs as they were."""
    torch = _need_card()
    from hydragnn_tpu_torch.export import make_forward
    from hydragnn_tpu_torch.serve.engine import ServingEngine

    model, cfg, samples, st, budgets = _tiny_engine_case(torch)
    keys = [(b.num_nodes, b.num_edges, b.num_graphs) for b in budgets]
    eng = ServingEngine(model, cfg, None, budgets, example=samples[0], settings=st,
                        device="cuda")
    want = _serve_all(eng, samples, budgets)
    fwd = make_forward(eng.model, cfg)
    allocated = []
    for _ in range(3):
        eng.install_executables({k: fwd for k in keys})
        torch.cuda.synchronize()
        assert sorted(eng.graphs.graphs) == sorted(keys)
        allocated.append(torch.cuda.memory_allocated())
    assert allocated[2] == allocated[1], allocated
    steps = dict(eng.graphs.graphs)
    runs, captures = eng.warm_runs, eng.graphs.captures

    def broken(batch):
        raise RuntimeError("warm-up refused")

    with pytest.raises(RuntimeError, match="warm-up refused"):
        eng.install_executables({**{k: fwd for k in keys[:-1]}, keys[-1]: broken})
    torch.cuda.synchronize()
    assert all(eng.graphs.graphs[k] is steps[k] for k in keys) and eng.warm_runs == runs
    assert len(eng.graphs.graphs) == len(keys)
    assert eng.graphs.captures == captures + len(keys) - 1
    assert torch.cuda.memory_allocated() == allocated[2]
    for got, ref in zip(_serve_all(eng, samples, budgets), want):
        for x, y in zip(got, ref):
            np.testing.assert_array_equal(x, y)
    eng.close()


@pytest.mark.cuda
def test_ensure_fields_engine_on_card():
    """A periodic example (a cell, edge shifts) fixes the captured batch
    structure: bare molecules fail at the static buffers without
    ``ensure_fields`` and are served with it, equal to a direct forward
    on the same bin bit for bit."""
    torch = _need_card()
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.export import make_forward
    from hydragnn_tpu_torch.serve.batcher import DynamicBatcher
    from hydragnn_tpu_torch.serve.engine import ServingEngine

    model, cfg, samples, st, budgets = _tiny_engine_case(torch)
    rng = np.random.default_rng(4)
    base = samples[0]
    example = GraphSample(
        x=base.x, pos=base.pos, edge_index=base.edge_index, cell=np.eye(3, dtype=np.float32),
        edge_shifts=rng.integers(-1, 2, size=(base.num_edges, 3)).astype(np.float32))
    bare = [GraphSample(x=s.x, pos=s.pos, edge_index=s.edge_index) for s in samples[1:]]
    strict = ServingEngine(model, cfg, None, budgets, example=example, settings=st,
                           device="cuda")
    bat = DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
    bat.submit(bare[0])
    bat.close()
    with pytest.raises(ValueError, match="static batch fields"):
        strict.process(bat)
    strict.close()
    eng = ServingEngine(model, cfg, None, budgets, example=example, settings=st,
                        ensure_fields={"edge_shifts": 3, "cell": 9}, device="cuda")
    bat = DynamicBatcher(budgets, deadline_ms=1e3, max_open_bins=2)
    reqs = [bat.submit(s) for s in bare]
    bat.close()
    records = eng.process(bat)
    fwd = make_forward(eng.model, cfg)
    for rec in records:
        batch = eng.collate_bin([q.sample for q in rec["reqs"]], rec["spec"])
        assert {"edge_shifts", "cell"} <= set(batch.arrays())
        out = fwd(batch.to("cuda"))[0].cpu().numpy()
        for gi, q in enumerate(rec["reqs"]):
            np.testing.assert_array_equal(q.result[0], out[gi])
    assert all(r.result is not None for r in reqs)
    eng.close()


def _telemetry_run(torch, tmp_path, name, telemetry, feed=None):
    """ci.json's SchNet (24 BCC configurations, batches of 4, two epochs,
    the guard on) through run_training on the card, every step through
    the graph cache; with ``telemetry`` the stream on (a fence every 3
    dispatches); ``feed`` updates ``Parallelism`` (the input feed).
    Returns (state, history, stream rows or None)."""
    import copy
    import json
    import os

    from hydragnn_tpu_torch import runner
    from hydragnn_tpu_torch.data.synthetic import deterministic_graph_data

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "inputs", "ci.json")) as f:
        config = json.load(f)
    data = str(tmp_path / "data")
    if not os.path.isdir(data):
        deterministic_graph_data(data, number_configurations=24, seed=5)
    config = copy.deepcopy(config)
    config["Dataset"]["path"] = {"total": data}
    config["Dataset"]["name"] = name
    t = config["NeuralNetwork"]["Training"]
    t.update(num_epoch=2, batch_size=4, Guard={"enabled": True},
             Parallelism={"scheme": "single", "packing": {"enabled": False}, **(feed or {})})
    if telemetry:
        t["Telemetry"] = {"enabled": True, "sync_interval_steps": 3,
                          "heartbeat_interval_s": 600}
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        state, _, _, hist, full = runner.run_training(config, device="cuda")
        torch.cuda.synchronize()
        rows = None
        if telemetry:
            with open(os.path.join("logs", full["_log_name"], "telemetry.jsonl")) as f:
                rows = [json.loads(line) for line in f]
    finally:
        os.chdir(cwd)
    return state, hist, rows


@pytest.mark.cuda
def test_telemetry_on_equals_off_replayed(tmp_path):
    """run_training with the telemetry stream on equals the run with it
    off bit for bit on the card (history, parameters, optimizer state),
    every step replayed after its shape's first sight; the stream has a
    counted executable per (region, spec, k), no capture_error, one
    compile row per capture and the card's name in its header."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    launches = {}
    runs = {}
    for name, on in (("on", True), ("off", False)):
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        runs[name] = _telemetry_run(torch, tmp_path, f"tel_{name}", on)
        launches[name] = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
    (s_on, h_on, rows), (s_off, h_off, _) = runs["on"], runs["off"]
    assert launches["on"] == launches["off"]
    assert h_on.train_loss == h_off.train_loss and h_on.val_loss == h_off.val_loss
    _state_equal(torch, s_on.model, s_on.optimizer, s_off.model, s_off.optimizer)
    assert s_on.graphs.replays > 0
    assert rows[0]["device_kind"] == torch.cuda.get_device_name(0)
    execs = [r for r in rows if r["t"] == "executable"]
    assert execs and not [r for r in execs if "capture_error" in r]
    steps = {(r["region"], r["spec"], r["k"]) for r in rows if r["t"] == "step"}
    assert {(r["region"], r["spec"], r["k"]) for r in execs} == steps
    assert len([r for r in rows if r["t"] == "compile"]) == s_on.graphs.captures


@pytest.mark.cuda
def test_pipeline_feed_equals_serial_on_card(tmp_path):
    """run_training through three collation workers (buffers recycled:
    the loop copies each batch to the card) and the prefetch thread
    equals the serial feed bit for bit on the card (history, parameters,
    optimizer state, K1/K2 launches), every step replayed after its
    shape's first sight: the captures the loop thread records while the
    workers collate succeed (no capture_error), the train feed's stats
    carry its host-to-device time, and the run captured what the serial
    run captured, epoch by epoch."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    feeds = {"pipeline": {"pipeline": {"workers": 3, "depth": 2, "chunk": 1}, "prefetch": 2},
             "serial": {"pipeline": {"workers": 0}, "prefetch": 0}}
    launches, runs = {}, {}
    for name, feed in feeds.items():
        edge_pipeline_planned.launches = edge_pipeline_bwd_planned.launches = 0
        runs[name] = _telemetry_run(torch, tmp_path, f"feed_{name}", True, feed)
        launches[name] = (edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches)
    (s_p, h_p, rows), (s_s, h_s, _) = runs["pipeline"], runs["serial"]
    assert launches["pipeline"] == launches["serial"] and launches["serial"][0] > 0
    assert h_p.train_loss == h_s.train_loss and h_p.val_loss == h_s.val_loss
    assert h_p.test_loss == h_s.test_loss and h_p.epoch_captures == h_s.epoch_captures
    _state_equal(torch, s_p.model, s_p.optimizer, s_s.model, s_s.optimizer)
    assert s_p.graphs.replays > 0 and s_p.graphs.captures == s_s.graphs.captures
    execs = [r for r in rows if r["t"] == "executable"]
    assert execs and not [r for r in execs if "capture_error" in r]
    pipe = [r for r in rows if r["t"] == "pipeline"]
    assert len(pipe) == 6 and pipe[3]["h2d_s_total"] > 0 and pipe[3]["epochs"] == 2


@pytest.mark.cuda
def test_counter_k1_k2_equal_work_on_card():
    """The dispatch-mode counter around K1 and its backward (K2) on the
    card counts what ``k1_work``/``k2_work`` say, with the valid slots
    read from the plan."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops import edge_pipeline as ep
    from hydragnn_tpu_torch.utils.telemetry import ExecCounter

    rng, plan = _plan(11, 900, 1024, 300)
    dev = torch.device("cuda")
    plan = tuple(torch.from_numpy(p).to(dev) for p in plan)
    f_in, f_out = 128, 128
    a, b = (torch.tensor(rng.normal(size=(1024, f_in)), dtype=torch.float32, device=dev,
                         requires_grad=True) for _ in range(2))
    w = torch.tensor(rng.normal(size=(f_in, f_out)) / f_in ** 0.5, dtype=torch.float32,
                     device=dev, requires_grad=True)

    def step(batches):
        out = ep.edge_pipeline_planned(a, b, w, *plan, 300)
        out.square().sum().backward()
        return (out.detach(),)

    ctr = ExecCounter()
    k1_before, k2_before = ep.edge_pipeline_planned.launches, ep.edge_pipeline_bwd_planned.launches
    ctr.run(step, [])
    torch.cuda.synchronize()
    assert (ep.edge_pipeline_planned.launches - k1_before,
            ep.edge_pipeline_bwd_planned.launches - k2_before) == (1, 1)
    e_valid = int(plan[2].sum())
    slots, blocks = plan[0].numel(), plan[3].numel()
    k1 = ep.k1_work(e_valid, 300, f_in, f_out, slots, blocks, a.dtype, w.dtype, True, True)
    k2 = ep.k2_work(1024, e_valid, 300, f_in, f_out, slots, blocks, a.dtype, w.dtype,
                    True, True)
    got1 = ctr.kernels["hydragnn::edge_pipeline"]
    got2 = ctr.kernels["hydragnn::edge_pipeline_bwd"]
    assert ctr.error is None
    assert (got1["calls"], got1["flops"], got1["bytes_accessed"]) == (1, k1[1], k1[0])
    assert (got2["calls"], got2["flops"], got2["bytes_accessed"]) == (1, k2[1], k2[0])


def _rollout_lists(torch, n=22, box=6.1, radius=4.4, max_edges=1024, seed=0):
    """A rollout's neighbor list on the card (md17's 21 atoms and one
    padding row, the list radius 4.0 + skin 0.4): (senders, receivers,
    edge_mask), receiver-sorted by ``radius_graph_device``."""
    from hydragnn_tpu_torch.ops.neighbors import radius_graph_device

    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(0, box, (n, 3)).astype(np.float32)).cuda()
    pos[-1] = 0.0
    ngi = torch.zeros(n, dtype=torch.int32, device="cuda")
    ngi[-1] = 1
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    mask[-1] = False
    snd, rcv, em, _ = radius_graph_device(pos, radius, ngi, mask, max_edges)
    return snd, rcv, em


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64, 192])
def test_device_plan_kernels_match_plain(f):
    """K1 and K2 (reduce-only, PaiNN's widths) on a block plan built on
    the card from ``radius_graph_device``'s list: the plan equals the host
    planner's, each kernel equals its plain version, the same bits on
    two runs."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops import edge_pipeline as ep

    n = 22
    _, rcv, em = _rollout_lists(torch, n)
    e = rcv.numel()
    bound = ep.static_block_bound(e, n)
    plan = ep.plan_blocks_device(rcv, em, n, bound)
    want = ep.plan_blocks_static(rcv.cpu().numpy(), n, bound, edge_valid=em.cpu().numpy())
    for w, g in zip(want, plan):
        assert np.array_equal(w, g.cpu().numpy())
    gen = torch.Generator(device="cuda").manual_seed(f)
    a = torch.randn(e, f, device="cuda", generator=gen)
    g = torch.randn(n, f, device="cuda", generator=gen)
    out = ep.edge_pipeline_planned(a, None, None, *plan, n)
    ref = ep.edge_pipeline_plain(a, None, None, *plan, n)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **TOL["float32"])
    assert torch.equal(out, ep.edge_pipeline_planned(a, None, None, *plan, n))
    d_a = ep.edge_pipeline_bwd_planned(g, a, None, None, *plan, n)[0]
    d_ref = ep.edge_pipeline_bwd_plain(g, a, None, None, *plan, n)[0]
    np.testing.assert_allclose(d_a.cpu().numpy(), d_ref.cpu().numpy(), **VJP_TOL["float32"])
    assert torch.equal(d_a, ep.edge_pipeline_bwd_planned(g, a, None, None, *plan, n)[0])


@pytest.mark.cuda
def test_rollout_captured_macro_equals_serial():
    """A PaiNN rollout on the card: a K = 8 captured macro (eager, then
    captured and replayed) equals K = 1 bit for bit, with the Langevin
    thermostat and rebuilds; every force pass launches 6 K1 and 6 K2
    (three layers, two receiver sums each), replays included."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )
    from hydragnn_tpu_torch.simulate import RolloutEngine, md_template_batch, simulation_settings

    model, cfg, samples = _painn_serving(torch)
    smp = samples[0]
    block = {"steps": 32, "dt": 2e-3, "temperature_k": 0.2, "kb": 1.0, "seed": 3,
             "thermostat": "langevin", "friction": 0.5,
             "neighbor": {"skin": 0.05, "max_edges": 256}}
    out = {}
    for k in (1, 8):
        s = simulation_settings({"Simulation": dict(block, superstep_k=k)})
        eng = RolloutEngine(model, None, cfg,
                            md_template_batch(smp.x, smp.pos, s.neighbor.max_edges), s)
        st = eng.init_state()
        k1, k2 = edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches
        res = eng.run(st, record=True)
        torch.cuda.synchronize()
        launches = (edge_pipeline_planned.launches - k1, edge_pipeline_bwd_planned.launches - k2)
        assert launches == (6 * 32, 6 * 32), (k, launches)
        stats = eng.graph_stats()
        assert (stats["eager_runs"], stats["captures"], stats["replays"]) == (
            1, 1, 32 // k - 1), stats
        out[k] = res
    assert out[1].stats["rebuilds"] == out[8].stats["rebuilds"] > 0
    for name in ("trajectory", "velocities", "energies", "kinetic"):
        assert np.array_equal(getattr(out[1], name), getattr(out[8], name)), name


@pytest.mark.cuda
def test_runs_share_one_side_stream_and_keep_memory_flat():
    """Every StepGraphs (and rollout engine) of a card makes its eager
    runs on one side stream, so a run's cuBLAS workspaces (one per handle
    and stream, never freed by torch) outlive no run: after two
    run_trainings with dropped states, device memory is what it was after
    the first."""
    import gc

    torch = _need_card()
    from hydragnn_tpu_torch.data.loader import split_dataset
    from hydragnn_tpu_torch.drivers.qm9 import synthetic_qm9
    from hydragnn_tpu_torch.drivers.qm9_hpo import hpo_config
    from hydragnn_tpu_torch.runner import run_training
    from hydragnn_tpu_torch.train.capture import StepGraphs, side_stream

    assert StepGraphs("cuda")._side is StepGraphs("cuda:0")._side is side_stream(0)
    datasets = split_dataset(synthetic_qm9(60), 0.8)
    after = []
    for _ in range(2):
        state = run_training(hpo_config(2), datasets=datasets, device="cuda")[0]
        assert state.graphs.replays > 0
        del state
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert abs(after[1] - after[0]) < 2**20, after
