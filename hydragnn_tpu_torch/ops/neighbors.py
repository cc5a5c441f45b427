"""Host neighbour lists: radius graphs, periodic radius graphs and
connectivity repair.

Counterpart of the host half of ``hydragnn_tpu/ops/neighbors.py``:
``radius_graph`` (its numpy cell list, ``_cell_list_pairs``, and the
per-receiver cap ``_cap_neighbors``), ``radius_graph_pbc`` (the image
search over a triclinic cell with mixed periodicity) and
``ensure_connected``. Both builders take the native C++ cell list
(``native.py``, the port's copy of the JAX package's source) whenever it
builds, as the JAX package does, and fall back to numpy where it declines
the geometry (``NativeUnsupported``). ``HYDRAGNN_TPU_NO_NATIVE=1`` (the
JAX package's switch) keeps the numpy path, which stays the reference.
The two find the same edges in different orders; each equals the JAX
package's same path element for element (the numpy code is copied, the
C++ is the same source).

``radius_graph_device`` is the counterpart of ``radius_graph_jax``, the
fixed-capacity neighbor list the MD rollout builds on the device every step
(``simulate/engine.py``); it imports torch when called, so the host
neighbor lists keep a numpy-only import.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _native_available() -> bool:
    """The C++ cell list unless ``HYDRAGNN_TPU_NO_NATIVE`` is set (or the
    library does not build)."""
    if os.environ.get("HYDRAGNN_TPU_NO_NATIVE"):
        return False
    from hydragnn_tpu_torch import native

    return native.available()


def radius_graph(
    pos: np.ndarray,
    radius: float,
    *,
    max_neighbours: Optional[int] = None,
    loop: bool = False,
) -> np.ndarray:
    """All directed edges (s, r) with |pos_s - pos_r| <= radius, as
    edge_index [2, E] (senders in row 0, receivers in row 1);
    ``max_neighbours`` keeps each receiver's nearest senders."""
    pos = np.asarray(pos, dtype=np.float64)
    if pos.shape[0] == 0:
        return np.zeros((2, 0), dtype=np.int64)
    if not loop and _native_available():
        from hydragnn_tpu_torch.native import NativeUnsupported, radius_graph_native

        try:
            ei = radius_graph_native(pos, radius)
        except NativeUnsupported:
            pass
        else:
            return _cap_neighbors(ei[0], ei[1], pos, None, max_neighbours)[0]
    senders, receivers, _ = _cell_list_pairs(pos, radius, loop=loop)
    return _cap_neighbors(senders, receivers, pos, None, max_neighbours)[0]


def radius_graph_pbc(
    pos: np.ndarray,
    cell: np.ndarray,
    radius: float,
    *,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
    max_neighbours: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Periodic radius graph over a triclinic cell: every (s, r, image)
    with |pos_s + image @ cell - pos_r| <= radius, the zero image's
    self pairs left out (a small cell gives self-image edges, s == r with
    a nonzero shift). Returns (edge_index [2, E], shifts [E, 3]) with
    displacement = pos[s] - pos[r] + shift against the caller's own
    (possibly unwrapped) positions."""
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    if pos.shape[0] == 0:
        return np.zeros((2, 0), dtype=np.int64), np.zeros((0, 3))
    if _native_available():
        from hydragnn_tpu_torch.native import NativeUnsupported, radius_graph_pbc_native

        try:
            ei, sh = radius_graph_pbc_native(pos, cell, radius, tuple(pbc))
        except NativeUnsupported:
            pass
        else:
            return _cap_neighbors(ei[0], ei[1], pos, sh, max_neighbours)

    # Images per axis: the distance between opposite faces must cover
    # the cutoff.
    recip = np.linalg.inv(cell.T)
    heights = 1.0 / np.linalg.norm(recip, axis=1)
    n_images = [int(np.ceil(radius / h)) if p else 0 for h, p in zip(heights, pbc)]

    # Search on positions wrapped into the primary cell, keeping each
    # atom's wrap offset: pos_w[i] = pos[i] - wrap_off[i] @ cell.
    frac = pos @ np.linalg.inv(cell)
    wrap_off = np.zeros_like(frac)
    if any(pbc):
        wrap = np.array([1.0 if p else 0.0 for p in pbc])
        wrap_off = np.floor(frac) * wrap
        pos = (frac - wrap_off) @ cell

    senders_l, receivers_l, shifts_l = [], [], []
    r2 = radius * radius
    for ix in range(-n_images[0], n_images[0] + 1):
        for iy in range(-n_images[1], n_images[1] + 1):
            for iz in range(-n_images[2], n_images[2] + 1):
                shift = np.array([ix, iy, iz], dtype=np.float64) @ cell
                diff = pos[None, :, :] + shift[None, None, :] - pos[:, None, :]
                mask = np.einsum("ijk,ijk->ij", diff, diff) <= r2
                if ix == 0 and iy == 0 and iz == 0:
                    np.fill_diagonal(mask, False)
                rcv, snd = np.nonzero(mask)
                if rcv.size:
                    senders_l.append(snd)
                    receivers_l.append(rcv)
                    shifts_l.append(np.tile(shift, (rcv.size, 1)))
    if not senders_l:
        return np.zeros((2, 0), dtype=np.int64), np.zeros((0, 3))
    edge_index, shifts = _cap_neighbors(
        np.concatenate(senders_l), np.concatenate(receivers_l), pos,
        np.concatenate(shifts_l), max_neighbours,
    )
    # Re-express the shifts against the caller's unwrapped positions.
    shifts = shifts + (wrap_off[edge_index[1]] - wrap_off[edge_index[0]]) @ cell
    return edge_index, shifts


def ensure_connected(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Connectivity repair: add artificial chain edges (both directions)
    between the components a radius cutoff left apart."""
    parent = np.arange(num_nodes)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for s, r in edge_index.T:
        ra, rb = find(int(s)), find(int(r))
        if ra != rb:
            parent[ra] = rb
    roots = sorted({find(i) for i in range(num_nodes)})
    if len(roots) <= 1:
        return edge_index
    extra = []
    for a, b in zip(roots[:-1], roots[1:]):
        extra.append((a, b))
        extra.append((b, a))
    extra = np.array(extra, dtype=edge_index.dtype).T
    return np.concatenate([edge_index, extra], axis=1)


def _cell_list_pairs(pos: np.ndarray, radius: float, *, loop: bool):
    """Binned pair search; returns (senders, receivers, d2) numpy arrays."""
    n = pos.shape[0]
    lo = pos.min(axis=0)
    cell_size = max(radius, 1e-12)
    bins = np.floor((pos - lo) / cell_size).astype(np.int64)
    nbins = bins.max(axis=0) + 1
    key = (bins[:, 0] * nbins[1] + bins[:, 1]) * nbins[2] + bins[:, 2]
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    senders_l, receivers_l, d2_l = [], [], []
    uniq, starts = np.unique(sorted_key, return_index=True)
    starts = np.append(starts, n)
    bin_of = {int(k): i for i, k in enumerate(uniq)}
    r2 = radius * radius
    offsets = [
        (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    ]
    for bi, k in enumerate(uniq):
        members = order[starts[bi] : starts[bi + 1]]
        kz = int(k) % nbins[2]
        ky = (int(k) // nbins[2]) % nbins[1]
        kx = int(k) // (nbins[1] * nbins[2])
        cand = []
        for dx, dy, dz in offsets:
            nx, ny, nz = kx + dx, ky + dy, kz + dz
            if not (0 <= nx < nbins[0] and 0 <= ny < nbins[1] and 0 <= nz < nbins[2]):
                continue
            bj = bin_of.get(int((nx * nbins[1] + ny) * nbins[2] + nz))
            if bj is not None:
                cand.append(order[starts[bj] : starts[bj + 1]])
        cand = np.concatenate(cand)
        diff = pos[cand][None, :, :] - pos[members][:, None, :]
        d2 = np.einsum("ijk,ijk->ij", diff, diff)
        mask = d2 <= r2
        if not loop:
            mask &= members[:, None] != cand[None, :]
        ri, ci = np.nonzero(mask)
        if ri.size:
            receivers_l.append(members[ri])
            senders_l.append(cand[ci])
            d2_l.append(d2[ri, ci])
    if not senders_l:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0)
    return (
        np.concatenate(senders_l),
        np.concatenate(receivers_l),
        np.concatenate(d2_l),
    )


def _cap_neighbors(senders, receivers, pos, shifts, max_neighbours):
    """Keep at most ``max_neighbours`` nearest senders per receiver (a
    stable sort by distance, the image ``shifts`` added where given), in
    the input's order. Returns (edge_index [2, E], the kept shifts or
    None)."""
    if max_neighbours is None:
        return np.stack([senders, receivers]).astype(np.int64), shifts
    if shifts is None:
        d2 = np.sum((pos[senders] - pos[receivers]) ** 2, axis=1)
    else:
        d2 = np.sum((pos[senders] + shifts - pos[receivers]) ** 2, axis=1)
    keep = np.zeros(senders.shape[0], dtype=bool)
    for r in np.unique(receivers):
        idx = np.nonzero(receivers == r)[0]
        if idx.size > max_neighbours:
            idx = idx[np.argsort(d2[idx], kind="stable")[:max_neighbours]]
        keep[idx] = True
    edge_index = np.stack([senders[keep], receivers[keep]]).astype(np.int64)
    return edge_index, None if shifts is None else shifts[keep]


def radius_graph_device(pos, radius: float, node_graph_idx, node_mask, max_edges: int):
    """Fixed-capacity radius graph on the tensors' device: the
    counterpart of ``radius_graph_jax``, element for element.

    A dense pair test over the ``[N, N]`` grid (same graph, both nodes
    real, no self pairs, ``d2 <= radius * radius`` in float32), then a
    stable compaction: the flat pair index ``r * N + s`` of every true
    entry in ascending order, so the edges come sorted by receiver, then
    the false entries, cut to ``max_edges`` slots (to ``N * N`` where the
    grid is smaller, as the reference's slice is). Empty slots park on
    the last node ``N - 1`` with a False mask. Returns ``(senders,
    receivers, edge_mask, overflow)``: int32, int32, bool, and the 0-d
    int32 count of true pairs that found no slot. No value is read back
    to the host (no ``nonzero``, no ``masked_select``), so the list is
    built inside a captured CUDA graph."""
    import torch

    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    same_graph = node_graph_idx[None, :] == node_graph_idx[:, None]
    valid = node_mask[None, :] & node_mask[:, None]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    adj = (d2 <= radius * radius) & same_graph & valid & ~eye
    flat = adj.reshape(-1)
    total = torch.sum(flat.to(torch.int32))
    # the true entries first, each group in index order
    order = torch.argsort((~flat).to(torch.int32), stable=True)
    taken = order[:max_edges]
    edge_mask = flat[taken]
    pad_node = n - 1
    rcv = torch.where(edge_mask, taken // n, pad_node).to(torch.int32)
    snd = torch.where(edge_mask, taken % n, pad_node).to(torch.int32)
    overflow = torch.clamp(total - max_edges, min=0).to(torch.int32)
    return snd, rcv, edge_mask, overflow
