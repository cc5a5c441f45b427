"""K1 and K2 on the card: the Hopper kernels against their plain versions.

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


# (real edges, padded edges, nodes, F). The last two put more valid slots
# in a node window than the kernels stage in one pass (kChunk = 256 in
# csrc/*.cu), so a warp's row sums carry across passes: ~1,350 valid
# slots in each of 2 windows, and the headline train step's density
# (~265 per window) over 82 windows, whose d_W partials K2 folds in order.
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
