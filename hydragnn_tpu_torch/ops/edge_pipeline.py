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
  route and no fallback between the two.

The JAX kernel's tiles (be=512, bn=256) were sized for the TPU's VMEM and
its 128x128 matrix unit. On Hopper one CTA owns one node window and keeps
its ``[bn, F_in]`` f32 accumulator in shared memory, so the port's
defaults are small: a qm9 serving bin of 32 graphs has about 600 nodes,
and bn=32 gives it about 20 CTAs where bn=256 would give 3. The plan
contract (aligned tiles, invalid padding slots, one all-invalid block
per empty window, padding blocks that repeat the last window) is the
JAX package's, unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Hopper tile sizes (the TPU kernel used be=512, bn=256).
DEFAULT_BE = 64  # plan slots per block (an aligned tile of sorted edges)
DEFAULT_BN = 32  # node-window rows (one CTA each)

# Dynamic shared memory a Hopper block may opt into (232,448 bytes), and
# the floats the kernel stages beside its window tiles (a 64 x 128 W chunk
# and 256 (row, edge) slot pairs; csrc/edge_pipeline.cu::smem_floats).
_MAX_SMEM = 232448
_STAGED_FLOATS = 64 * 128 + 2 * 256


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
# K1: the fused edge pipeline
# ----------------------------------------------------------------------


def _out_dtype(a: torch.Tensor, w: Optional[torch.Tensor]) -> torch.dtype:
    return torch.promote_types(a.dtype, w.dtype) if w is not None else a.dtype


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
    matmul, ``index_add_`` into the segments, in f32, and cast once to
    ``promote(a, W)``. Invalid slots are selected to zero (never
    multiplied), as in the TPU kernel. ``window_id``/``be`` are unused
    here: slots carry their own segment ids."""
    del window_id, be
    f_out = w.shape[1] if w is not None else a.shape[1]
    out_dtype = _out_dtype(a, w)
    if a.shape[0] == 0:
        return torch.zeros((num_segments, f_out), dtype=out_dtype, device=a.device)
    idx = perm.long()
    msg = a.float()[idx]
    if b is not None:
        msg = msg * b.float()[idx]
    msg = torch.where(valid[:, None], msg, 0.0)
    if w is not None:
        msg = msg @ w.float()
    n_pad = max((num_segments + bn - 1) // bn, 1) * bn
    out = torch.zeros((n_pad, f_out), dtype=torch.float32, device=a.device)
    out.index_add_(0, seg_padded.long(), msg)
    return out[:num_segments].to(out_dtype)


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
    """``segment_sum((a * b) @ w)`` over a block plan: ``[N, F_out]``.

    A CUDA ``a`` launches the Hopper kernel (and counts the launch in
    ``edge_pipeline_planned.launches``); a CPU ``a`` runs
    ``edge_pipeline_plain``. Anything else raises. E=0 returns zeros of
    the output dtype without a launch. Padding edges are invalid plan
    slots (``plan_sorted_blocks(edge_valid=...)``), so callers must not
    pre-mask the operands."""
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


edge_pipeline_planned.launches = 0


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


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"edge_pipeline_planned: {msg}")


def _edge_pipeline_cuda(
    a, b, w, perm, seg_padded, valid, window_id, num_segments, bn, be
) -> torch.Tensor:
    """Validate, allocate the output, launch the kernel on the current
    stream and count the launch. Raises on anything the kernel does not
    take; never falls back."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, w)
    ):
        raise NotImplementedError(
            "edge_pipeline_planned on CUDA is forward-only: its backward "
            "kernel (K2) comes with the training slice (ROADMAP Queue 2); "
            "call it under torch.no_grad()"
        )
    dev = a.device
    tensors = {"a": a, "b": b, "w": w, "perm": perm, "seg_padded": seg_padded,
               "valid": valid, "window_id": window_id}
    for name, t in tensors.items():
        if t is None:
            continue
        _check(t.device == dev, f"{name} is on {t.device}, a is on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(a.dtype in _DTYPE_CODE, f"a must be float32 or bfloat16, got {a.dtype}")
    _check(a.dim() == 2, f"a must be [E, F_in], got {tuple(a.shape)}")
    e, f_in = a.shape
    if b is not None:
        _check(b.dtype == a.dtype and b.shape == a.shape,
               f"b must match a ({a.dtype}, {tuple(a.shape)}), got "
               f"({b.dtype}, {tuple(b.shape)})")
    f_out = f_in
    if w is not None:
        _check(w.dtype == a.dtype, f"w must be {a.dtype}, got {w.dtype}")
        _check(w.dim() == 2 and w.shape[0] == f_in,
               f"w must be [{f_in}, F_out], got {tuple(w.shape)}")
        f_out = w.shape[1]
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
    # The kernel gives each of up to 8 slot-walking warps its own f32
    # [bn, F_in] tile, as many as fit; it needs room for one at least.
    smem = 4 * (bn * f_in + _STAGED_FLOATS)
    _check(smem <= _MAX_SMEM,
           f"a [{bn}, {f_in}] f32 window tile needs {smem} bytes of shared "
           f"memory > {_MAX_SMEM}; use a smaller bn")
    from hydragnn_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    out = torch.empty((num_segments, f_out), dtype=a.dtype, device=dev)
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
            _DTYPE_CODE[a.dtype], int(b is not None), int(w is not None),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"edge_pipeline kernel launch failed: CUDA error {err} "
            f"({lib.hg_cuda_error_string(err).decode(errors='replace')})"
        )
    edge_pipeline_planned.launches += 1
    return out

