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
  CUDA tensors, ``edge_pipeline_bwd_plain`` on CPU tensors.

Both are dispatcher operators (``torch.ops.hydragnn.edge_pipeline`` and
``torch.ops.hydragnn.edge_pipeline_bwd``) with fake implementations, so
``torch.export`` records them as nodes of an exported program. K1's
derivative is K2, and K2's derivative (forces of an interatomic
potential differentiated again) is written with K1 and K2 once more.

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


def plan_blocks_device(
    seg_sorted: torch.Tensor,
    edge_valid: torch.Tensor,
    num_segments: int,
    n_blocks_static: int,
    be: int = DEFAULT_BE,
    bn: int = DEFAULT_BN,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``plan_blocks_static`` computed on the tensors' device: the same
    ``(perm, seg_padded, valid, window_id)``, element for element, for a
    non-decreasing ``seg_sorted`` [E] and its ``edge_valid`` mask.

    No JAX counterpart: the JAX rollout's force pass carries no plan and
    sums with XLA. The MD rollout (``simulate/engine.py``) plans each
    step's neighbor list here, whose receivers ``radius_graph_device``
    returns sorted, so that every force pass runs K1 and K2 with no
    host round trip. Each window's edge run comes from ``searchsorted``,
    its tile count and its first block from a ``cumsum``, and block k
    finds its window by a ``searchsorted`` of k in the block offsets;
    blocks past the plan's end are the static padding (tile 0, no valid
    slot, the last window). Shapes are static and no value is read
    back to the host, so a captured CUDA graph replays it. The bound
    must hold every plan of E edges (``static_block_bound``): a plan's
    size is not known on the host, so a smaller bound raises here."""
    dev = seg_sorted.device
    e = int(seg_sorted.shape[0])
    need = static_block_bound(e, num_segments, be, bn)
    if n_blocks_static < need:
        raise ValueError(
            f"plan_blocks_device needs a static bound of at least {need} blocks "
            f"for {e} edges over {num_segments} segments, got {n_blocks_static}"
        )
    n_windows = max((num_segments + bn - 1) // bn, 1)
    seg = seg_sorted.to(torch.int64)
    wins = torch.arange(n_windows, dtype=torch.int64, device=dev)
    windows = seg // bn
    starts = torch.searchsorted(windows, wins, right=False)
    ends = torch.searchsorted(windows, wins, right=True)
    filled = ends > starts
    first_tile = torch.where(filled, starts // be, 0)
    n_tiles = torch.where(filled, (ends - 1) // be - starts // be + 1, 1)
    block_end = torch.cumsum(n_tiles, 0)
    k = torch.arange(n_blocks_static, dtype=torch.int64, device=dev)
    w = torch.clamp(torch.searchsorted(block_end, k, right=True), max=n_windows - 1)
    pad = k >= block_end[-1]
    tile = first_tile[w] + k - (block_end[w] - n_tiles[w])
    rows = tile[:, None] * be + torch.arange(be, dtype=torch.int64, device=dev)[None, :]
    rows_c = torch.clamp(rows, max=max(e - 1, 0))
    valid = (rows >= starts[w][:, None]) & (rows < ends[w][:, None]) & ~pad[:, None]
    if e:
        valid = valid & edge_valid[rows_c]
        seg_rows = seg[rows_c]
    else:
        seg_rows = rows_c
    seg_p = torch.where(valid, seg_rows, (w * bn)[:, None])
    perm = torch.where(pad[:, None], 0, rows_c)
    return (perm.reshape(-1).to(torch.int32), seg_p.reshape(-1).to(torch.int32),
            valid.reshape(-1), w.to(torch.int32))


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


# ----------------------------------------------------------------------
# The work K1 and K2 do: the bytes they must move and the operations
# they must do, the count behind both the kernel table's bound column
# (chip_smoke.py) and the counted executables (utils/telemetry.py)
# ----------------------------------------------------------------------


def _size(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def k1_work(e_valid, n, f_in, f_out, slots, blocks, a_dt, w_dt, has_b, has_w):
    """K1's bytes (valid edge rows of a and b, W, the plan read once; the
    output written once) and operations (the multiply, the reduce adds,
    one [N, F_in] @ [F_in, F_out]); returns (bytes, ops, output dtype)."""
    out_dt = torch.promote_types(a_dt, w_dt) if has_w else a_dt
    nbytes = (
        e_valid * f_in * _size(a_dt) * (2 if has_b else 1)
        + (f_in * f_out * _size(w_dt) if has_w else 0)
        + slots * (4 + 4 + 1) + blocks * 4
        + n * f_out * _size(out_dt)
    )
    ops = e_valid * f_in * (2 if has_b else 1) + (2 * n * f_in * f_out if has_w else 0)
    return nbytes, ops, out_dt


def k2_work(e, e_valid, n, f_in, f_out, slots, blocks, a_dt, w_dt, has_b, has_w):
    """K2's bytes (g, the plan, W and the valid edge rows of whichever of
    a and b the outputs need, read once; d_a, d_b and d_W written once)
    and operations (g @ W^T and msg_sum^T @ g per node, the per-edge
    products and message sums); returns (bytes, ops, cotangent dtype)."""
    g_dt = torch.promote_types(a_dt, w_dt) if has_w else a_dt
    reads_a = has_b or has_w
    nbytes = (
        n * f_out * _size(g_dt) + slots * (4 + 4 + 1) + blocks * 4
        + e_valid * f_in * _size(a_dt) * (int(reads_a) + int(has_b))
        + (2 * f_in * f_out * _size(w_dt) if has_w else 0)
        + e * f_in * _size(a_dt) * (2 if has_b else 1)
    )
    ops = e_valid * f_in * ((2 if has_b else 0) + (2 if has_w else 0))
    if has_w:
        ops += 4 * n * f_in * f_out
    return nbytes, ops, g_dt


def kernel_work(func, args) -> Optional[tuple]:
    """``(name, bytes, ops, plan sizes)`` of one call of K1's or K2's
    operator with ``args`` (``k1_work``/``k2_work`` on its operands; the
    valid slot count is read from the plan), None for any other op. A
    call with no edges launches nothing and counts nothing."""
    if func is torch.ops.hydragnn.edge_pipeline.default:
        a, b, w, perm, _, valid, window_id, n = args[:8]
        bwd = False
    elif func is torch.ops.hydragnn.edge_pipeline_bwd.default:
        _, a, b, w, perm, _, valid, window_id, n = args[:9]
        bwd = True
    else:
        return None
    e, f_in = a.shape
    f_out = w.shape[1] if w is not None else f_in
    w_dt = w.dtype if w is not None else a.dtype
    slots, blocks = perm.numel(), window_id.numel()
    e_valid = int(valid.sum()) if e else 0
    sizes = {"e": int(e), "e_valid": e_valid, "n": int(n), "f_in": int(f_in),
             "f_out": int(f_out), "slots": slots, "blocks": blocks}
    if not e:
        return ("hydragnn::edge_pipeline_bwd" if bwd else "hydragnn::edge_pipeline",
                0, 0, sizes)
    if bwd:
        nbytes, ops, _ = k2_work(e, e_valid, n, f_in, f_out, slots, blocks, a.dtype, w_dt,
                                 b is not None, w is not None)
        return "hydragnn::edge_pipeline_bwd", nbytes, ops, sizes
    nbytes, ops, _ = k1_work(e_valid, n, f_in, f_out, slots, blocks, a.dtype, w_dt,
                             b is not None, w is not None)
    return "hydragnn::edge_pipeline", nbytes, ops, sizes


# ----------------------------------------------------------------------
# K1 and K2 as dispatcher operators
# ----------------------------------------------------------------------
#
# Both kernels are operators, ``torch.ops.hydragnn.edge_pipeline`` (K1)
# and ``torch.ops.hydragnn.edge_pipeline_bwd`` (K2), each with a CPU
# implementation (the plain version), a CUDA one (the kernel), a fake one
# (output shapes only) and a derivative. A trace on fake tensors
# (``torch.export``) records each call as one node of the program instead
# of entering the ctypes launch, and a loaded program differentiates
# through K2 as the live model does. An operator cannot return None, so
# K2 returns an empty tensor where b or W is absent; the Python wrappers
# below turn it back into None. The registration uses the low-level
# ``torch.library.Library`` API, whose dispatch does not import
# ``torch._dynamo`` (``torch.library.custom_op`` does, at the first call).

_LIB = torch.library.Library("hydragnn", "DEF")
_LIB.define(
    "edge_pipeline(Tensor a, Tensor? b, Tensor? w, Tensor perm, Tensor seg_padded, "
    "Tensor valid, Tensor window_id, int num_segments, int bn, int be) -> Tensor"
)
_LIB.define(
    "edge_pipeline_bwd(Tensor g, Tensor a, Tensor? b, Tensor? w, Tensor perm, "
    "Tensor seg_padded, Tensor valid, Tensor window_id, int num_segments, int bn, "
    "int be) -> (Tensor, Tensor, Tensor)"
)


def _absent(a: torch.Tensor) -> torch.Tensor:
    """K2's stand-in for the gradient of an absent operand."""
    return a.new_empty(0)


def _k2_impl(g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be):
    d_a, d_b, d_w = _edge_pipeline_bwd(
        g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
    )
    return d_a, _absent(a) if d_b is None else d_b, _absent(a) if d_w is None else d_w


def _k1_fake(a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be):
    f_out = w.shape[1] if w is not None else a.shape[1]
    return a.new_empty((num_segments, f_out), dtype=_out_dtype(a, w))


def _k2_fake(g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be):
    return (
        torch.empty_like(a),
        _absent(a) if b is None else torch.empty_like(b),
        _absent(a) if w is None else torch.empty_like(w),
    )


for _key in ("CPU", "CUDA"):
    _LIB.impl("edge_pipeline", lambda *args: _edge_pipeline_fwd(*args), _key)
    _LIB.impl("edge_pipeline_bwd", lambda *args: _k2_impl(*args), _key)
torch.library.register_fake("hydragnn::edge_pipeline", _k1_fake, lib=_LIB)
torch.library.register_fake("hydragnn::edge_pipeline_bwd", _k2_fake, lib=_LIB)


def _k1_setup(ctx, inputs, output):
    a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be = inputs
    ctx.save_for_backward(a, b, w, perm, seg_padded, valid, window_id)
    ctx.plan_sizes = (num_segments, bn, be)


def _k1_backward(ctx, g):
    """K1's derivative is K2 (through its operator, so a backward that
    builds a graph records K2 and can differentiate it again)."""
    a, b, w, perm, seg_padded, valid, window_id = ctx.saved_tensors
    grads = edge_pipeline_bwd_planned(
        g, a, b, w, perm, seg_padded, valid, window_id, *ctx.plan_sizes
    )
    need = ctx.needs_input_grad
    return tuple(d if n else None for d, n in zip(grads, need)) + (None,) * 7


def _add(x: Optional[torch.Tensor], y: Optional[torch.Tensor]):
    return y if x is None else x if y is None else x + y


def _k2_setup(ctx, inputs, output):
    g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be = inputs
    ctx.save_for_backward(g, a, b, w, perm, seg_padded, valid, window_id)
    ctx.plan_sizes = (num_segments, bn, be)
    ctx.set_materialize_grads(False)


def _k2_backward(ctx, u_a, u_b, u_w):
    """K2's derivative, written with K1 and K2 themselves plus
    elementwise ops, so every second-order launch is one of the two
    kernels. The JAX package has no kernel here: its pullback is
    differentiable XLA ops (``_edge_pipeline_bwd_xla``), and this is
    their derivative.

    With ``sg = g[seg]`` at valid slots, ``d_h = sg @ W^T`` and
    ``(u_a, u_b, u_W)`` the cotangents of ``(d_a, d_b, d_W)``, and
    ``c = u_a * b + u_b * a``:

        g_bar = K1(c, -, W) + K1(a, b, u_W)
        a_bar = u_b * d_h + b * (sg @ u_W^T)
        b_bar = u_a * d_h + a * (sg @ u_W^T)
        W_bar = sum_e c[e]^T sg[e]

    ``d_h`` and ``W_bar`` are one K2 launch with ``a := c`` and no b (its
    d_a and d_W), and ``sg @ u_W^T`` is K2's d_a with ``W := u_W``. Terms
    of absent operands drop out: without b, ``c = u_a`` and the products
    by b and a go; in the reduce-only flavour ``g_bar = K1(u_a)`` and
    nothing else. Every row no valid slot covers gets exactly zero, as
    in the first order."""
    g, a, b, w, *plan = ctx.saved_tensors
    plan = (*plan, *ctx.plan_sizes)
    need_g, need_a, need_b, need_w = ctx.needs_input_grad[:4]
    # The empty stand-ins of absent operands carry no cotangent.
    u_b = None if b is None else u_b
    u_w = None if w is None else u_w
    # Cotangents arrive in any layout (an expanded zero, a view);
    # the kernels take contiguous rows of the primal's type.
    u_a, u_b, u_w = (
        None if u is None else u.to(x.dtype).contiguous()
        for u, x in ((u_a, a), (u_b, b), (u_w, w))
    )
    # Elementwise products in f32 (f64 for f64), one cast each.
    ct = _acc_dtype(a.dtype)

    def mul(x, y):
        return None if x is None or y is None else x.to(ct) * y.to(ct)

    def cast(x, dtype):
        return None if x is None else x.to(dtype)

    c = u_a if b is None else cast(_add(mul(u_a, b), mul(u_b, a)), a.dtype)
    g_bar = a_bar = b_bar = w_bar = None
    if need_g:
        if c is not None:
            g_bar = edge_pipeline_planned(c, None, w, *plan)
        if u_w is not None:
            g_bar = _add(g_bar, edge_pipeline_planned(a, b, u_w, *plan))
    d_h = sg_uw = None
    if c is not None and (
        (need_a and u_b is not None) or (need_b and u_a is not None)
        or (need_w and w is not None)
    ):
        d_h, _, w_bar = edge_pipeline_bwd_planned(g, c, None, w, *plan)
    if u_w is not None and (need_a or need_b):
        sg_uw = edge_pipeline_bwd_planned(g, a, None, u_w, *plan)[0]
    if need_a:
        # without b, d_W = sum a^T sg: a's share of u_W is sg @ u_W^T
        from_w = sg_uw if b is None else mul(b, sg_uw)
        a_bar = cast(_add(mul(u_b, d_h), from_w), a.dtype)
    if need_b and b is not None:
        b_bar = cast(_add(mul(u_a, d_h), mul(a, sg_uw)), b.dtype)
    return (g_bar, a_bar, b_bar, w_bar if need_w else None) + (None,) * 7


torch.library.register_autograd(
    "hydragnn::edge_pipeline", _k1_backward, setup_context=_k1_setup, lib=_LIB
)
torch.library.register_autograd(
    "hydragnn::edge_pipeline_bwd", _k2_backward, setup_context=_k2_setup, lib=_LIB
)


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
    ``promote(a, W)``, through K1's operator.

    A CUDA ``a`` launches the Hopper kernel K1 (and counts the launch in
    ``edge_pipeline_planned.launches``); a CPU ``a`` runs
    ``edge_pipeline_plain``. Anything else raises. The operator's
    derivative is K2 (``edge_pipeline_bwd_planned``). E=0 returns zeros
    without a launch. Padding edges are invalid plan slots
    (``plan_sorted_blocks(edge_valid=...)``), so callers must not
    pre-mask the operands."""
    return torch.ops.hydragnn.edge_pipeline(
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
    ``[N, F_out]``: ``(d_a, d_b, d_W)``, None for an absent operand,
    through K2's operator.

    A CUDA ``a`` launches the Hopper kernel K2 (counted in
    ``edge_pipeline_bwd_planned.launches``); a CPU ``a`` runs
    ``edge_pipeline_bwd_plain``. Anything else raises. E=0 returns empty
    d_a/d_b and a zero d_W without a launch."""
    d_a, d_b, d_w = torch.ops.hydragnn.edge_pipeline_bwd(
        g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
    )
    return d_a, None if b is None else d_b, None if w is None else d_w


edge_pipeline_bwd_planned.launches = 0


def _edge_pipeline_bwd(
    g, a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
):
    """K2 without autograd: zeros for E=0, the plain version on the CPU,
    the kernel on CUDA."""
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
