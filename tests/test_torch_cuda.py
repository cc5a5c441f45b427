"""K1 on the card: the Hopper kernel against its plain PyTorch version.

These tests need a CUDA device and skip without one (the decision is
made inside each test). This file imports no JAX, so it also runs where
JAX is not installed; there, skip the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

# tests/test_pallas_segment.py:341-342 — the fused kernel's tolerances.
TOL = {
    "float32": dict(rtol=1e-5, atol=1e-4),
    "bfloat16": dict(rtol=4e-2, atol=2.5e-1),
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


def _case(torch, seed, e_real, e_pad, n, f_in, f_out, dtype, be=64, bn=32):
    """A served-bin-like case: receiver-sorted real edges, padding edges
    masked out of the plan, static block padding."""
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
    dev = torch.device("cuda")
    a = torch.tensor(rng.normal(size=(e_pad, f_in)), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(size=(e_pad, f_in)), dtype=dtype, device=dev)
    w = torch.tensor(
        rng.normal(size=(f_in, f_out)) / np.sqrt(f_in), dtype=dtype, device=dev
    )
    perm, seg_p, valid, window = (torch.from_numpy(p).to(dev) for p in plan)
    return a, b, w, perm, seg_p, valid, window


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("stages", ["a", "ab", "abw"])
def test_kernel_matches_plain(stages, dt):
    """Each flavour, both dtypes: the kernel equals its plain version
    within the fused kernel's tolerances, and two runs give the same
    bits."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_plain,
        edge_pipeline_planned,
    )

    dtype = getattr(torch, dt)
    for seed, (e_real, e_pad, n, f) in enumerate(
        [(1250, 1280, 640, 128), (37, 64, 200, 16), (300, 304, 40, 128)]
    ):
        a, b, w, perm, seg_p, valid, window = _case(
            torch, seed, e_real, e_pad, n, f, f, dtype
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
        assert got.dtype == ref.dtype == dtype
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dt])


@pytest.mark.cuda
def test_kernel_edge_cases():
    """E=0 returns zeros without a launch; a plan built at the TPU's
    tiles (be=512, bn=256) runs through the same kernel; a gradient
    request raises instead of silently dropping the gradient."""
    torch = _need_card()
    from hydragnn_tpu_torch.ops.edge_pipeline import (
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
    w.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        edge_pipeline_planned(a, b, w, perm, seg_p, valid, window, 300)
