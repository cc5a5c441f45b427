"""The fused edge pipeline over sorted-segment block plans.

Counterpart of ``hydragnn_tpu/ops/pallas_segment.py``. It holds two
parts:

- the HOST block planner (``plan_sorted_blocks``, ``plan_blocks_static``,
  ``static_block_bound``), a numpy copy of the JAX package's, with the
  tile sizes ``be`` (plan slots per block) and ``bn`` (node-window rows)
  as parameters;
- kernel K1, ``edge_pipeline_planned``:

      out[n] = sum over valid plan slots s with seg[s] == n of
               (a[perm[s]] * b[perm[s]]) @ W                [N, F_out]

  with ``b`` and ``W`` each optional. On a CUDA tensor it launches the
  hand-written Hopper kernel in ``csrc/edge_pipeline.cu`` (built by
  ``ops/cuda_build.py`` at first use); on a CPU tensor it runs the plain
  PyTorch version ``edge_pipeline_plain`` below. There is no other
  route and no fallback between the two;
- kernel K2, ``edge_pipeline_bwd_planned``, K1's pullback (d_a, d_b,
  d_W for a cotangent of the output): ``csrc/edge_pipeline_bwd.cu`` on
  CUDA tensors, ``edge_pipeline_bwd_plain`` on CPU tensors. Autograd
  reaches it through ``EdgePipelineFn``, which ``edge_pipeline_planned``
  takes whenever an operand needs a gradient.

The JAX kernel's tiles (be=512, bn=256) were sized for the TPU's VMEM and
its 128x128 matrix unit. On Hopper one CTA owns one node window and one
32-column slab of F_in, so the port's defaults are small: a qm9 serving
bin of 32 graphs has about 600 nodes, and bn=32 gives it about 20
windows (80 CTAs at F_in = 128) where bn=256 would give 3. The plan
contract (aligned tiles, invalid padding slots, one all-invalid block
per empty window, padding blocks that repeat the last window) is the
JAX package's, unchanged. The kernels rely on its tile form: every
block reads one contiguous be-row tile of the sorted edges,
``perm[k*be + i] = min(t*be + i, E-1)`` with ``t = perm[k*be] // be``,
which they stage with asynchronous copies instead of gathering rows
(tests/test_torch_ops.py pins it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

# Hopper tile sizes (the TPU kernel used be=512, bn=256).
DEFAULT_BE = 64  # plan slots per block (an aligned tile of sorted edges)
DEFAULT_BN = 32  # node-window rows (one CTA each)


def plan_sorted_blocks(
    seg_sorted: np.ndarray,
    num_segments: int,
    be: int = DEFAULT_BE,
    bn: int = DEFAULT_BN,
    edge_valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Split sorted segment ids into window-aligned tile blocks.

    Each block covers one be-aligned tile of the sorted edge array (rows
    ``[t*be, (t+1)*be)``); a window's run ``[a, b)`` maps to the tiles it
    touches, with rows outside the run marked invalid (a boundary tile
    is visited once by each adjacent window). ``edge_valid`` (optional
    ``[E]`` bool) masks padding edges out of the plan itself.

    Returns (perm, seg_padded, valid, window_id):
      perm      [B*be] int32 — edge row per slot (tile arange, clamped
                to E-1 past the array end; masked by ``valid``)
      seg_padded[B*be] int32 — segment id per slot (window start for
                invalid slots)
      valid     [B*be] bool
      window_id [B]    int32 — node window of each block (non-decreasing)
    """
    seg = np.asarray(seg_sorted, np.int64)
    e = len(seg)
    n_windows = max((num_segments + bn - 1) // bn, 1)
    windows = seg // bn
    ev = None if edge_valid is None else np.asarray(edge_valid, bool)
    # Edge run per window; an empty window still gets one all-invalid
    # block so its output rows are written (as zeros).
    starts = np.searchsorted(windows, np.arange(n_windows), side="left")
    ends = np.searchsorted(windows, np.arange(n_windows), side="right")
    perm_l, seg_l, val_l, win_l = [], [], [], []
    for w in range(n_windows):
        a, b = int(starts[w]), int(ends[w])
        tiles = range(a // be, (b - 1) // be + 1) if b > a else (0,)
        for t in tiles:
            rows = np.arange(t * be, (t + 1) * be)
            valid = (rows >= a) & (rows < b)
            rows_c = np.minimum(rows, max(e - 1, 0))
            if ev is not None:
                valid &= ev[rows_c]
            segs = np.full(be, w * bn, np.int64)
            segs[valid] = seg[rows_c[valid]]
            perm_l.append(rows_c)
            seg_l.append(segs)
            val_l.append(valid)
            win_l.append(w)
    return (
        np.concatenate(perm_l).astype(np.int32),
        np.concatenate(seg_l).astype(np.int32),
        np.concatenate(val_l),
        np.asarray(win_l, np.int32),
    )


def plan_blocks_static(
    seg_sorted: np.ndarray,
    num_segments: int,
    n_blocks_static: int,
    be: int = DEFAULT_BE,
    bn: int = DEFAULT_BN,
    edge_valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``plan_sorted_blocks`` padded to a static block count, so every
    batch of one padded shape carries plans of one shape. Padding blocks
    repeat the last window, read tile 0 and hold no valid slots."""
    perm, seg_p, valid, window = plan_sorted_blocks(
        seg_sorted, num_segments, be, bn, edge_valid=edge_valid
    )
    b = len(window)
    if b > n_blocks_static:
        raise ValueError(
            f"plan needs {b} blocks > static bound {n_blocks_static}"
        )
    pad = n_blocks_static - b
    if pad:
        perm = np.concatenate([perm, np.zeros(pad * be, np.int32)])
        seg_p = np.concatenate(
            [seg_p, np.full(pad * be, int(window[-1]) * bn, np.int32)]
        )
        valid = np.concatenate([valid, np.zeros(pad * be, bool)])
        window = np.concatenate(
            [window, np.full(pad, window[-1], np.int32)]
        )
    return perm, seg_p, valid, window


def static_block_bound(
    num_edges: int,
    num_segments: int,
    be: int = DEFAULT_BE,
    bn: int = DEFAULT_BN,
) -> int:
    """Upper bound on a plan's block count: every window adds at most
    one boundary-tile revisit to the ``ceil(E/be)`` tiles."""
    return (num_edges + be - 1) // be + (num_segments + bn - 1) // bn


# ----------------------------------------------------------------------
# K1 (the fused edge pipeline) and K2 (its pullback)
# ----------------------------------------------------------------------


def _out_dtype(a: torch.Tensor, w: Optional[torch.Tensor]) -> torch.dtype:
    return torch.promote_types(a.dtype, w.dtype) if w is not None else a.dtype


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: f32 for f32/bf16 (the
    kernels' accumulator), f64 for f64 (gradient checks)."""
    return torch.promote_types(torch.float32, dtype)


def edge_pipeline_plain(
    a: torch.Tensor,
    b: Optional[torch.Tensor],
    w: Optional[torch.Tensor],
    perm: torch.Tensor,
    seg_padded: torch.Tensor,
    valid: torch.Tensor,
    window_id: torch.Tensor,
    num_segments: int,
    bn: int = DEFAULT_BN,
    be: int = DEFAULT_BE,
) -> torch.Tensor:
    """K1's plain PyTorch version: gather the plan slots, multiply,
    matmul, ``index_add_`` into the segments, in f32 (f64 for f64
    operands), and cast once to ``promote(a, W)``. Invalid slots are
    selected to zero (never multiplied), as in the TPU kernel.
    ``window_id``/``be`` are unused here: slots carry their own segment
    ids."""
    del window_id, be
    f_out = w.shape[1] if w is not None else a.shape[1]
    out_dtype = _out_dtype(a, w)
    ct = _acc_dtype(out_dtype)
    if a.shape[0] == 0:
        return torch.zeros((num_segments, f_out), dtype=out_dtype, device=a.device)
    idx = perm.long()
    msg = a.to(ct)[idx]
    if b is not None:
        msg = msg * b.to(ct)[idx]
    msg = torch.where(valid[:, None], msg, 0.0)
    if w is not None:
        msg = msg @ w.to(ct)
    n_pad = max((num_segments + bn - 1) // bn, 1) * bn
    out = torch.zeros((n_pad, f_out), dtype=ct, device=a.device)
    out.index_add_(0, seg_padded.long(), msg)
    return out[:num_segments].to(out_dtype)


def edge_pipeline_bwd_plain(
    g: torch.Tensor,
    a: torch.Tensor,
    b: Optional[torch.Tensor],
    w: Optional[torch.Tensor],
    perm: torch.Tensor,
    seg_padded: torch.Tensor,
    valid: torch.Tensor,
    window_id: torch.Tensor,
    num_segments: int,
    bn: int = DEFAULT_BN,
    be: int = DEFAULT_BE,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K2's plain PyTorch version, after the JAX package's XLA pullback
    (``_edge_pipeline_bwd_xla``): ``slot_g = g[seg]`` at valid slots,
    ``d_h = slot_g @ W^T``, ``d_a = d_h * b``, ``d_b = d_h * a``
    (scattered to the edge rows), ``d_W = msg^T @ slot_g``, in f32 (f64
    for f64 operands) with one terminal cast to each operand's type.
    Returns ``(d_a, d_b, d_W)`` with None for an absent operand. Invalid
    slots are selected away after the products, and ``g`` is never
    indexed past ``num_segments`` (their ``seg`` may lie in the padded
    window)."""
    del window_id, bn, be
    ct = _acc_dtype(torch.promote_types(a.dtype, g.dtype))
    d_w = None if w is None else torch.zeros(w.shape, dtype=w.dtype, device=a.device)
    if a.shape[0] == 0:
        return (
            torch.zeros_like(a),
            None if b is None else torch.zeros_like(b),
            d_w,
        )
    vm = valid[:, None]
    idx = perm.long()
    rows = seg_padded.long().clamp(max=num_segments - 1)
    slot_g = torch.where(vm, g.to(ct)[rows], 0.0)  # [S, F_out]
    a_s = a.to(ct)[idx]
    b_s = None if b is None else b.to(ct)[idx]
    if w is not None:
        msg = a_s if b_s is None else a_s * b_s
        msg = torch.where(vm, msg, 0.0)
        d_w = (msg.T @ slot_g).to(w.dtype)
        d_h = slot_g @ w.to(ct).T  # [S, F_in]
    else:
        d_h = slot_g

    def scatter(rows_grad):
        out = torch.zeros(a.shape, dtype=ct, device=a.device)
        return out.index_add_(0, idx, torch.where(vm, rows_grad, 0.0))

    if b_s is None:
        return scatter(d_h).to(a.dtype), None, d_w
    return scatter(d_h * b_s).to(a.dtype), scatter(d_h * a_s).to(b.dtype), d_w


@once_differentiable
def _pullback(ctx, g):
    a, b, w, perm, seg_padded, valid, window_id = ctx.saved_tensors
    d_a, d_b, d_w = edge_pipeline_bwd_planned(
        g, a, b, w, perm, seg_padded, valid, window_id, *ctx.plan_sizes
    )
    need = ctx.needs_input_grad
    return (
        d_a if need[0] else None,
        d_b if need[1] else None,
        d_w if need[2] else None,
    ) + (None,) * 7


class EdgePipelineFn(torch.autograd.Function):
    """``edge_pipeline_planned`` with a gradient: K1 forward and K2
    backward on CUDA tensors, ``edge_pipeline_plain`` and
    ``edge_pipeline_bwd_plain`` on CPU tensors. The backward is
    ``once_differentiable``, and a backward asked to build a graph
    (``create_graph=True``, as forces of an interatomic potential need)
    raises instead of returning a gradient whose own gradient is
    silently missing."""

    @staticmethod
    def forward(ctx, a, b, w, perm, seg_padded, valid, window_id,
                num_segments, bn, be):
        ctx.save_for_backward(a, b, w, perm, seg_padded, valid, window_id)
        ctx.plan_sizes = (num_segments, bn, be)
        return _edge_pipeline_fwd(
            a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
        )

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the edge pipeline's backward (K2) is differentiable once; "
                "second derivatives (interatomic-potential forces) wait for "
                "the MLIP slice: ROADMAP Queue 1 item 7"
            )
        return _pullback(ctx, g)


def edge_pipeline_planned(
    a: torch.Tensor,
    b: Optional[torch.Tensor],
    w: Optional[torch.Tensor],
    perm: torch.Tensor,
    seg_padded: torch.Tensor,
    valid: torch.Tensor,
    window_id: torch.Tensor,
    num_segments: int,
    bn: int = DEFAULT_BN,
    be: int = DEFAULT_BE,
) -> torch.Tensor:
    """``segment_sum((a * b) @ w)`` over a block plan: ``[N, F_out]`` in
    ``promote(a, W)``.

    A CUDA ``a`` launches the Hopper kernel K1 (and counts the launch in
    ``edge_pipeline_planned.launches``); a CPU ``a`` runs
    ``edge_pipeline_plain``. Anything else raises. When an operand needs
    a gradient the call goes through ``EdgePipelineFn``, whose backward
    is K2 (``edge_pipeline_bwd_planned``). E=0 returns zeros without a
    launch. Padding edges are invalid plan slots
    (``plan_sorted_blocks(edge_valid=...)``), so callers must not
    pre-mask the operands."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, w)
    ):
        return EdgePipelineFn.apply(
            a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
        )
    return _edge_pipeline_fwd(
        a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
    )


edge_pipeline_planned.launches = 0


def edge_pipeline_bwd_planned(
    g: torch.Tensor,
    a: torch.Tensor,
    b: Optional[torch.Tensor],
    w: Optional[torch.Tensor],
    perm: torch.Tensor,
    seg_padded: torch.Tensor,
    valid: torch.Tensor,
    window_id: torch.Tensor,
    num_segments: int,
    bn: int = DEFAULT_BN,
    be: int = DEFAULT_BE,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The pullback of ``edge_pipeline_planned`` for the cotangent ``g``
    ``[N, F_out]``: ``(d_a, d_b, d_W)``, None for an absent operand.

    A CUDA ``a`` launches the Hopper kernel K2 (counted in
    ``edge_pipeline_bwd_planned.launches``); a CPU ``a`` runs
    ``edge_pipeline_bwd_plain``. Anything else raises. E=0 returns empty
    d_a/d_b and a zero d_W without a launch."""
    if a.shape[0] == 0:
        return (
            torch.zeros_like(a),
            None if b is None else torch.zeros_like(b),
            None if w is None else torch.zeros_like(w),
        )
    if a.device.type == "cpu":
        return edge_pipeline_bwd_plain(
            g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
        )
    if a.device.type != "cuda":
        raise ValueError(
            f"edge_pipeline_bwd_planned runs on CUDA or CPU tensors, got "
            f"{a.device}"
        )
    return _edge_pipeline_bwd_cuda(
        g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
    )


edge_pipeline_bwd_planned.launches = 0


def segment_sum_planned(
    data, perm, seg_padded, valid, window_id, num_segments,
    bn: int = DEFAULT_BN, be: int = DEFAULT_BE,
) -> torch.Tensor:
    """Sorted-segment sum over a block plan (K1's reduce-only flavour)."""
    return edge_pipeline_planned(
        data, None, None, perm, seg_padded, valid, window_id,
        num_segments, bn, be,
    )


def segment_sum_product_planned(
    a, b, perm, seg_padded, valid, window_id, num_segments,
    bn: int = DEFAULT_BN, be: int = DEFAULT_BE,
) -> torch.Tensor:
    """Fused ``segment_sum(a * b)`` over a block plan (K1 without W)."""
    return edge_pipeline_planned(
        a, b, None, perm, seg_padded, valid, window_id,
        num_segments, bn, be,
    )


def _edge_pipeline_fwd(
    a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
) -> torch.Tensor:
    """K1 without autograd: zeros for E=0, the plain version on the CPU,
    the kernel on CUDA."""
    if a.shape[0] == 0:
        f_out = w.shape[1] if w is not None else a.shape[1]
        return torch.zeros(
            (num_segments, f_out), dtype=_out_dtype(a, w), device=a.device
        )
    if a.device.type == "cpu":
        return edge_pipeline_plain(
            a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
        )
    if a.device.type != "cuda":
        raise ValueError(
            f"edge_pipeline_planned runs on CUDA or CPU tensors, got "
            f"{a.device}"
        )
    return _edge_pipeline_cuda(
        a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
    )


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edge_pipeline: {msg}")


def _validate(a, b, w, perm, seg_padded, valid, window_id, num_segments, be):
    """Check what both kernels take; returns (E, F_in, F_out, blocks,
    dtype code): 0 = f32, 1 = bf16, 2 = bf16 a/b with an f32 W."""
    dev = a.device
    tensors = {"a": a, "b": b, "w": w, "perm": perm, "seg_padded": seg_padded,
               "valid": valid, "window_id": window_id}
    for name, t in tensors.items():
        if t is None:
            continue
        _check(t.device == dev, f"{name} is on {t.device}, a is on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(a.dtype in (torch.float32, torch.bfloat16),
           f"a must be float32 or bfloat16, got {a.dtype}")
    _check(a.dim() == 2, f"a must be [E, F_in], got {tuple(a.shape)}")
    e, f_in = a.shape
    if b is not None:
        _check(b.dtype == a.dtype and b.shape == a.shape,
               f"b must match a ({a.dtype}, {tuple(a.shape)}), got "
               f"({b.dtype}, {tuple(b.shape)})")
    f_out = f_in
    code = 0 if a.dtype == torch.float32 else 1
    if w is not None:
        _check(w.dtype == a.dtype or (a.dtype, w.dtype) == (torch.bfloat16, torch.float32),
               f"w must be {a.dtype} (or float32 with bfloat16 a), got {w.dtype}")
        _check(w.dim() == 2 and w.shape[0] == f_in,
               f"w must be [{f_in}, F_out], got {tuple(w.shape)}")
        f_out = w.shape[1]
        if w.dtype != a.dtype:
            code = 2
    n_blocks = window_id.numel()
    _check(window_id.dtype == torch.int32 and window_id.dim() == 1,
           "window_id must be a 1-D int32 tensor")
    for name in ("perm", "seg_padded"):
        t = tensors[name]
        _check(t.dtype == torch.int32 and t.shape == (n_blocks * be,),
               f"{name} must be int32 [{n_blocks * be}], got "
               f"{t.dtype} {tuple(t.shape)}")
    _check(valid.dtype == torch.bool and valid.shape == (n_blocks * be,),
           f"valid must be bool [{n_blocks * be}]")
    _check(n_blocks >= 1 and num_segments >= 1, "empty plan or output")
    _check(0 < e < 2**31 and f_in > 0 and f_out > 0, "bad operand sizes")
    return e, f_in, f_out, n_blocks, code


def _raise_on(lib, err: int, which: str, bn: int, f_out: int) -> None:
    """Raise on a launcher's CUDA error. The launchers return
    cudaErrorInvalidValue (1) when a window's tiles ([bn, F_out] and
    [bn, 32] per CTA) do not fit the card's shared memory."""
    if err == 0:
        return
    what = f"CUDA error {err} ({lib.hg_cuda_error_string(err).decode(errors='replace')})"
    if err == 1:
        raise ValueError(
            f"{which} refused bn={bn}, F_out={f_out}: {what}; its window "
            f"tiles do not fit the card's shared memory; use a smaller bn"
        )
    raise RuntimeError(f"{which} kernel launch failed: {what}")


def _edge_pipeline_cuda(
    a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
) -> torch.Tensor:
    """Validate, allocate the output, launch K1 on the current stream
    and count the launch. Raises on anything the kernel does not take;
    never falls back."""
    e, f_in, f_out, n_blocks, code = _validate(
        a, b, w, perm, seg_padded, valid, window_id, num_segments, be
    )
    from hydragnn_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    dev = a.device
    out = torch.empty((num_segments, f_out), dtype=_out_dtype(a, w), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_edge_pipeline_fwd(
            a.data_ptr(),
            None if b is None else b.data_ptr(),
            None if w is None else w.data_ptr(),
            perm.data_ptr(),
            seg_padded.data_ptr(),
            valid.view(torch.uint8).data_ptr(),
            window_id.data_ptr(),
            out.data_ptr(),
            e, num_segments, f_in, f_out, be, bn, n_blocks,
            code, int(b is not None), int(w is not None),
            stream,
        )
    _raise_on(lib, err, "edge_pipeline (K1)", bn, f_out)
    edge_pipeline_planned.launches += 1
    return out


def _edge_pipeline_bwd_cuda(
    g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
):
    """Validate, allocate d_a/d_b/d_W, the f32 d_W partials and the
    zeroed E-byte coverage mask (K2 writes every d_a/d_b row once and
    zeros the rows no valid slot covers, so the outputs need no memset),
    launch K2 on the current stream and count the launch. Raises on
    anything the kernel does not take; never falls back."""
    e, f_in, f_out, n_blocks, code = _validate(
        a, b, w, perm, seg_padded, valid, window_id, num_segments, be
    )
    dev = a.device
    g = g.contiguous()
    _check(g.device == dev and g.dtype == _out_dtype(a, w)
           and g.shape == (num_segments, f_out),
           f"g must be {_out_dtype(a, w)} [{num_segments}, {f_out}] on {dev}, "
           f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    from hydragnn_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    d_a = torch.empty_like(a)
    d_b = None if b is None else torch.empty_like(b)
    d_w = dw_part = None
    if w is not None:
        d_w = torch.empty_like(w)
        n_windows = (num_segments + bn - 1) // bn
        dw_part = torch.empty((n_windows, f_in, f_out), dtype=torch.float32, device=dev)
    covered = torch.zeros(e, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hg_edge_pipeline_bwd(
            g.data_ptr(),
            a.data_ptr(),
            None if b is None else b.data_ptr(),
            None if w is None else w.data_ptr(),
            perm.data_ptr(),
            seg_padded.data_ptr(),
            valid.view(torch.uint8).data_ptr(),
            window_id.data_ptr(),
            d_a.data_ptr(),
            None if d_b is None else d_b.data_ptr(),
            None if d_w is None else d_w.data_ptr(),
            None if dw_part is None else dw_part.data_ptr(),
            covered.data_ptr(),
            e, num_segments, f_in, f_out, be, bn, n_blocks,
            code, int(b is not None), int(w is not None),
            stream,
        )
    _raise_on(lib, err, "edge_pipeline_bwd (K2)", bn, f_out)
    edge_pipeline_bwd_planned.launches += 1
    return d_a, d_b, d_w
