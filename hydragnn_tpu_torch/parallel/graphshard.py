"""Graph-dimension parallelism: one giant graph sharded over ranks.

Counterpart of ``hydragnn_tpu/parallel/graphshard.py``. When a single
structure has too many atoms and edges for one card, its NODE and EDGE
dimensions are sharded over the ranks of a ``graph`` mesh axis
(``parallel/mesh.make_mesh({"graph": D})``): rank d of the axis stands in
for device d of the JAX package's mesh, and each rank runs the sharded
forward on its own block, as each device runs the body of ``shard_map``.

Two schemes, as in the JAX package:

- all-gather (``GraphShards``, ``sharded_mpnn_forward``): rank d holds
  node rows ``[d n_loc, (d+1) n_loc)`` and edge slots
  ``[d E_pad / D, (d+1) E_pad / D)`` with global ids;
  ``gather_nodes`` all-gathers the node rows and gathers per edge,
  ``scatter_nodes`` sums messages over the full node range and
  reduce-scatters them back to the shards;
- halo (``HaloShards``, ``halo_mpnn_forward``): edges live with the rank
  that owns their receiver, so the message sum is local, and
  ``halo_exchange`` moves only the boundary rows a neighbour references,
  one point-to-point shift per active ring-hop distance.

Global attention rides ``ring_attention`` in both: key and value blocks
rotate around the ring with an online softmax, so no rank holds the
full ``[N, N]`` scores.

The host side (``GraphShards.build``, ``HaloShards.build``, ``layout``,
``union_layout``) is the JAX package's numpy code, copied: every array
equals the JAX build's element for element. ``local(mesh, device)``
takes the place of ``device_put``: it returns this rank's block of every
array as tensors on ``device``.

Collectives are ``torch.autograd.Function``s over the mesh's group, so
backward runs the transposes on every rank in the same order:
all-gather <-> reduce-scatter, a ring shift <-> the reverse shift. The
total energy is a replicated scalar: its all-reduce's backward is the
identity, because every rank calls ``backward()`` on the same loss (an
all-reducing backward, as ``torch.distributed.nn.functional.all_reduce``
has, would scale every gradient by D). Parameter gradients are then each
rank's share; ``sum_gradients_`` sums them before the optimizer, which
is what JAX's transpose of a replicated input does.

Transport. NCCL, and gloo on CPU tensors, take the tensors where they
lie. Under gloo with CUDA tensors (ranks sharing one card, where NCCL
refuses two ranks on a device) the collectives that gloo does not take
on CUDA tensors copy to the host and back explicitly
(``transport``), decided by backend and collective kind; the compute
stays on the card. Every collective is timed into ``mesh.stats`` by
kind (calls, seconds; on a card under gloo the device is synchronized
around it, which the collective does anyway).

Gathers use ``index_select``, whose backward is a scatter-add, not
``x[idx]``, whose backward on a card is the serialized sorted
``index_put_`` (as ``models/dimenet.gather_rows``). Sums are
``ops/segment.segment_sum`` (``index_add_``), the counterpart of the
``jax.ops.segment_sum`` the JAX module calls; no Pallas kernel is on this
path in the JAX package, so neither K1 nor K2 is.

gloo collectives cannot be captured in a CUDA graph, so a graph-sharded
step runs eagerly (``parallel/dp.capturable``'s decision for gloo).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from hydragnn_tpu_torch.ops.rbf import cosine_cutoff, gaussian_smearing
from hydragnn_tpu_torch.ops.segment import segment_sum
from hydragnn_tpu_torch.parallel.mesh import GraphMesh

# ----------------------------------------------------------------------
# Host side: the partitions (numpy, the JAX package's arrays)
# ----------------------------------------------------------------------


def _index(a: np.ndarray, rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a[rows], np.int64), device=device)


def _block(a: np.ndarray, rows: slice, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a[rows]), device=device)


@dataclasses.dataclass
class GraphShards:
    """Host-side node/edge partition of ONE graph, padded to multiples
    of the axis size. Ids stay global; masks mark padding. ``build``
    holds numpy arrays; ``local`` one rank's block as tensors."""

    x: Any  # [N_pad, F]
    pos: Any  # [N_pad, 3]
    node_mask: Any  # [N_pad]
    senders: Any  # [E_pad] global ids
    receivers: Any  # [E_pad] global ids
    edge_mask: Any  # [E_pad]
    num_nodes_padded: int

    @staticmethod
    def build(
        x: np.ndarray,
        pos: np.ndarray,
        edge_index: np.ndarray,
        n_shards: int,
        edge_capacity: Optional[int] = None,
    ) -> "GraphShards":
        """``edge_capacity`` pads the edge dimension to a fixed bound so
        successive configurations of the same structure (whose true edge
        counts fluctuate) share one shape."""
        n, e = x.shape[0], edge_index.shape[1]
        e_cap = e
        if edge_capacity is not None:
            if e > edge_capacity:
                raise ValueError(f"{e} edges exceed edge_capacity={edge_capacity}")
            e_cap = edge_capacity
        n_pad = ((n + n_shards - 1) // n_shards) * n_shards
        e_pad = ((e_cap + n_shards - 1) // n_shards) * n_shards
        xp = np.zeros((n_pad, x.shape[1]), np.float32)
        xp[:n] = x
        pp = np.zeros((n_pad, 3), np.float32)
        pp[:n] = pos
        nm = np.zeros(n_pad, bool)
        nm[:n] = True
        snd = np.full(e_pad, n_pad - 1, np.int32)
        rcv = np.full(e_pad, n_pad - 1, np.int32)
        em = np.zeros(e_pad, bool)
        snd[:e] = edge_index[0]
        rcv[:e] = edge_index[1]
        em[:e] = True
        return GraphShards(x=xp, pos=pp, node_mask=nm, senders=snd, receivers=rcv,
                           edge_mask=em, num_nodes_padded=n_pad)

    def local(self, mesh: GraphMesh, device) -> "GraphShards":
        """This rank's block: node rows ``[r n_loc, (r+1) n_loc)``, edge
        slots ``[r E_pad / D, (r+1) E_pad / D)``, ids as int64."""
        r, d_ = mesh.index, mesh.size
        n_loc = self.num_nodes_padded // d_
        e_loc = self.senders.shape[0] // d_
        nodes = slice(r * n_loc, (r + 1) * n_loc)
        edges = slice(r * e_loc, (r + 1) * e_loc)
        return dataclasses.replace(
            self, x=_block(self.x, nodes, device), pos=_block(self.pos, nodes, device),
            node_mask=_block(self.node_mask, nodes, device),
            senders=_index(self.senders, edges, device),
            receivers=_index(self.receivers, edges, device),
            edge_mask=_block(self.edge_mask, edges, device))


@dataclasses.dataclass
class HaloShards:
    """Receiver-owned edge partition of ONE graph with halo-exchange
    lists, for ``halo_mpnn_forward``.

    Layout per rank d (n_loc = N_pad / D local node rows):
      - node arrays: global [N_pad, *] split by rows (d owns
        [d*n_loc, (d+1)*n_loc)).
      - edge arrays: [D * e_loc] — slot d holds exactly the edges whose
        RECEIVER d owns, so ``receivers_local`` is in [0, n_loc) and the
        message scatter is a local segment-sum.
      - ``senders_halo`` indexes the per-rank concatenation
        [local rows ; hop-1 halo block ; hop-2 halo block ; ...]: hop
        k's block (static capacity ``caps[k]``) receives, by ONE shift,
        the rows rank (d-k-1) mod D sends — the rows listed in its
        ``send_idx[:, k, :]`` slice.

    All capacities are host-computed maxima over ranks, so every shape
    is static; padded send slots duplicate row 0 (harmless: only masked
    edges can reference padded halo slots).
    """

    x: Any  # [N_pad, F]
    pos: Any  # [N_pad, 3]
    node_mask: Any  # [N_pad]
    senders_halo: Any  # [D*e_loc], halo-local layout
    receivers_local: Any  # [D*e_loc], [0, n_loc)
    edge_mask: Any  # [D*e_loc]
    send_idx: Any  # [D, K, cap_max] local rows per hop
    caps: Tuple[int, ...]  # static per-hop capacities (len K)
    num_nodes_padded: int
    n_shards: int
    hops: Tuple[int, ...] = ()  # active ring-hop distances minus 1
    e_loc: int = 0  # per-rank edge-slot capacity

    @property
    def layout(self) -> tuple:
        """(e_loc, hops, caps): the static shape signature. Successive
        configurations of one structure built with the same layout share
        one set of shapes (``build(..., layout=...)``)."""
        return (self.e_loc, self.hops, self.caps)

    @staticmethod
    def union_layout(shards: "Sequence[HaloShards]") -> tuple:
        """Smallest layout covering every given shards object — build
        probes unconstrained, union them, rebuild with the union."""
        hops_u = sorted(set().union(*[s.hops for s in shards]))
        caps_u = tuple(
            max((s.caps[s.hops.index(k)] if k in s.hops else 8 for s in shards), default=8)
            for k in hops_u
        )
        return (max(s.e_loc for s in shards), tuple(hops_u), caps_u)

    @property
    def n_loc(self) -> int:
        return self.num_nodes_padded // self.n_shards

    @property
    def halo_rows(self) -> int:
        """Per-rank feature rows a layer materializes (vs N_pad for the
        all-gather path) — the memory-model number."""
        return self.n_loc + sum(self.caps)

    @staticmethod
    def build(
        x: np.ndarray,
        pos: np.ndarray,
        edge_index: np.ndarray,
        n_shards: int,
        layout: Optional[tuple] = None,
    ) -> "HaloShards":
        """``layout`` (a ``.layout`` tuple / ``union_layout`` result) pins
        the static shapes so successive configurations of the same
        structure share them; raises when this graph's needs exceed it."""
        n = x.shape[0]
        d_ = n_shards
        n_pad = ((n + d_ - 1) // d_) * d_
        n_loc = n_pad // d_
        snd = np.asarray(edge_index[0], np.int64)
        rcv = np.asarray(edge_index[1], np.int64)
        owner_r = rcv // n_loc
        owner_s = snd // n_loc

        # Per-rank edge slots (receiver-owned), one shared capacity.
        by_dev = [np.nonzero(owner_r == d)[0] for d in range(d_)]
        e_loc = max((len(ix) for ix in by_dev), default=1)
        e_loc = max(((e_loc + 7) // 8) * 8, 8)
        if layout is not None and layout[0] < e_loc:
            raise ValueError(f"layout e_loc={layout[0]} < needed {e_loc}")
        if layout is not None:
            e_loc = layout[0]

        # Send lists: rows rank s must ship to s+k+1 (sorted global ids
        # -> positions are binary-searchable for the remap below).
        send_lists = [[np.zeros(0, np.int64) for _ in range(d_ - 1)] for _ in range(d_)]
        for d in range(d_):
            ed = by_dev[d]
            remote = ed[owner_s[ed] != d]
            for s in np.unique(owner_s[remote]):
                k = (d - s) % d_ - 1
                send_lists[int(s)][int(k)] = np.unique(snd[remote[owner_s[remote] == s]])
        cap_by_hop = [max(len(send_lists[s][k]) for s in range(d_)) for k in range(d_ - 1)]
        hops = [k for k in range(d_ - 1) if cap_by_hop[k] > 0]
        caps = tuple(max(((cap_by_hop[k] + 7) // 8) * 8, 8) for k in hops)
        if layout is not None:
            _, lay_hops, lay_caps = layout
            for k, c in zip(hops, caps):
                if k not in lay_hops:
                    raise ValueError(f"layout lacks required hop {k}")
                if lay_caps[lay_hops.index(k)] < c:
                    raise ValueError(
                        f"layout cap {lay_caps[lay_hops.index(k)]} < needed {c} at hop {k}"
                    )
            hops = list(lay_hops)
            caps = tuple(lay_caps)
        cap_max = max(caps, default=8)
        send_idx = np.zeros((d_, max(len(hops), 1), cap_max), np.int32)
        for s in range(d_):
            for ki, k in enumerate(hops):
                rows = send_lists[s][k] - s * n_loc  # local ids
                send_idx[s, ki, : len(rows)] = rows

        # Halo-local sender remap + per-rank edge arrays (the JAX
        # package's per-edge loop, by sending rank: the same values).
        offsets = {}
        off = n_loc
        for ki, k in enumerate(hops):
            offsets[k] = off
            off += caps[ki]
        sh = np.zeros(d_ * e_loc, np.int32)
        rl = np.zeros(d_ * e_loc, np.int32)
        em = np.zeros(d_ * e_loc, bool)
        for d in range(d_):
            ed = by_dev[d]
            base = d * e_loc
            rl[base: base + len(ed)] = rcv[ed] - d * n_loc
            src = owner_s[ed]
            col = np.where(src == d, snd[ed] - d * n_loc, 0)
            for s in np.unique(src[src != d]):
                k = int((d - s) % d_ - 1)
                sel = src == s
                col[sel] = offsets[k] + np.searchsorted(send_lists[int(s)][k], snd[ed[sel]])
            sh[base: base + len(ed)] = col
            em[base: base + len(ed)] = True

        xp = np.zeros((n_pad, x.shape[1]), np.float32)
        xp[:n] = x
        pp = np.zeros((n_pad, 3), np.float32)
        pp[:n] = pos
        nm = np.zeros(n_pad, bool)
        nm[:n] = True
        return HaloShards(
            x=xp, pos=pp, node_mask=nm, senders_halo=sh, receivers_local=rl, edge_mask=em,
            send_idx=send_idx, caps=caps, num_nodes_padded=n_pad, n_shards=d_,
            hops=tuple(hops), e_loc=e_loc,
        )

    def local(self, mesh: GraphMesh, device) -> "HaloShards":
        """This rank's block: node rows ``[r n_loc, (r+1) n_loc)``, edge
        slots ``[r e_loc, (r+1) e_loc)``, ``send_idx[r]`` ([K, cap_max]),
        ids as int64."""
        if mesh.size != self.n_shards:
            raise ValueError(f"shards built for {self.n_shards} ranks, mesh has {mesh.size}")
        r = mesh.index
        nodes = slice(r * self.n_loc, (r + 1) * self.n_loc)
        edges = slice(r * self.e_loc, (r + 1) * self.e_loc)
        return dataclasses.replace(
            self, x=_block(self.x, nodes, device), pos=_block(self.pos, nodes, device),
            node_mask=_block(self.node_mask, nodes, device),
            senders_halo=_index(self.senders_halo, edges, device),
            receivers_local=_index(self.receivers_local, edges, device),
            edge_mask=_block(self.edge_mask, edges, device),
            send_idx=_index(self.send_idx, r, device))


# ----------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------

# The collectives gloo takes on CUDA tensors where they lie (torch 2.11
# on an NVIDIA H100: all-reduce, all-gather and reduce-scatter give the
# right sums). Its point-to-point send and receive do not: they write
# from the device pointer as if it were host memory ("writev: Bad
# address") and the rank dies, so the ring shifts stage through the host.
GLOO_CUDA_TAKES = frozenset({"all_reduce", "all_gather", "reduce_scatter"})


def transport(mesh: GraphMesh, op: str, device: torch.device) -> str:
    """``"device"`` when the group's backend takes ``op``'s tensors on
    ``device`` where they lie, ``"host"`` when they are copied to the
    host and back (gloo on CUDA tensors, for the ops outside
    ``GLOO_CUDA_TAKES``): a decision by backend and op, never a retry."""
    if device.type != "cuda" or dist.get_backend(mesh.group) != dist.Backend.GLOO:
        return "device"
    return "device" if op in GLOO_CUDA_TAKES else "host"


def _run(mesh: GraphMesh, kind: str, op: str, fn: Callable, tensors: Sequence[torch.Tensor]):
    """``fn(tensors) -> outputs`` over ``transport``, timed into
    ``mesh.stats[kind]``."""
    dev = tensors[0].device
    via_host = transport(mesh, op, dev) == "host"
    sync = dev.type == "cuda" and dist.get_backend(mesh.group) != dist.Backend.NCCL
    if sync:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ins = [t.detach().contiguous() for t in tensors]
    if via_host:
        ins = [t.cpu() for t in ins]
    outs = fn(ins)
    if via_host:
        outs = [o.to(dev) for o in outs]
    if sync:
        torch.cuda.synchronize(dev)
    rec = mesh.stats.setdefault(kind, [0, 0.0])
    rec[0] += 1
    rec[1] += time.perf_counter() - t0
    return outs


def _all_gather(mesh: GraphMesh, x: torch.Tensor) -> torch.Tensor:
    def fn(ins):
        out = ins[0].new_empty((mesh.size * ins[0].shape[0],) + tuple(ins[0].shape[1:]))
        dist.all_gather(list(out.chunk(mesh.size)), ins[0], group=mesh.group)
        return [out]

    return _run(mesh, "all_gather", "all_gather", fn, [x])[0]


def _reduce_scatter(mesh: GraphMesh, x: torch.Tensor) -> torch.Tensor:
    def fn(ins):
        out = ins[0].new_empty((ins[0].shape[0] // mesh.size,) + tuple(ins[0].shape[1:]))
        dist.reduce_scatter(out, list(ins[0].chunk(mesh.size)), group=mesh.group)
        return [out]

    return _run(mesh, "reduce_scatter", "reduce_scatter", fn, [x])[0]


def _shift(mesh: GraphMesh, shift: int, tensors: Sequence[torch.Tensor],
           kind: str) -> List[torch.Tensor]:
    """Send each tensor to axis place ``index + shift`` and receive its
    counterpart from ``index - shift``: one ``batch_isend_irecv`` with
    every send and receive posted together (at D = 2 both peers are the
    same rank)."""
    def fn(ins):
        outs = [torch.empty_like(t) for t in ins]
        ops = []
        for t, o in zip(ins, outs):
            ops.append(dist.P2POp(dist.isend, t, mesh.peer(mesh.index + shift), group=mesh.group))
            ops.append(dist.P2POp(dist.irecv, o, mesh.peer(mesh.index - shift), group=mesh.group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return outs

    return _run(mesh, kind, "ppermute", fn, tensors)


def _all_reduce(mesh: GraphMesh, x: torch.Tensor, kind: str) -> torch.Tensor:
    def fn(ins):
        dist.all_reduce(ins[0], group=mesh.group)
        return ins

    return _run(mesh, kind, "all_reduce", fn, [x.clone()])[0]


class _AllGather(torch.autograd.Function):
    """Rows of every rank, in axis order (``jax.lax.all_gather(tiled=
    True)``); backward: reduce-scatter sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(ctx.mesh, g), None


class _ReduceScatter(torch.autograd.Function):
    """Sum over ranks, each keeping its rows (``psum_scatter(tiled=
    True)``); backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce_scatter(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.mesh, g), None


class _PPermute(torch.autograd.Function):
    """A ring shift (``jax.lax.ppermute`` with ``d -> d + shift``) of
    several tensors; backward: the reverse shift."""

    @staticmethod
    def forward(ctx, mesh, shift, kind, *tensors):
        ctx.mesh, ctx.shift, ctx.kind = mesh, shift, kind
        return tuple(_shift(mesh, shift, tensors, kind))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None) + tuple(_shift(ctx.mesh, -ctx.shift, grads, ctx.kind))


class _PsumReplicated(torch.autograd.Function):
    """The replicated total (``jax.lax.psum`` under ``out_specs=P()``);
    backward: the identity — every rank backpropagates the same loss, so
    each rank's share takes a cotangent of 1, not D."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(mesh, x, "psum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(mesh: GraphMesh, x: torch.Tensor) -> torch.Tensor:
    """[n, ...] on each rank -> [D n, ...], differentiable."""
    return _AllGather.apply(x, mesh)


def reduce_scatter(mesh: GraphMesh, x: torch.Tensor) -> torch.Tensor:
    """[D n, ...] on each rank -> the sum's rows [r n, (r+1) n), differentiable."""
    return _ReduceScatter.apply(x, mesh)


def ppermute(mesh: GraphMesh, shift: int, *tensors: torch.Tensor,
             kind: str = "ppermute") -> Tuple[torch.Tensor, ...]:
    """Each tensor from axis place ``index - shift``, differentiable."""
    return _PPermute.apply(mesh, shift, kind, *tensors)


def psum(mesh: GraphMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a replicated result (backward: identity)."""
    return _PsumReplicated.apply(x, mesh)


def sum_gradients_(params: Dict, mesh: GraphMesh) -> None:
    """All-reduce SUM of every parameter gradient, in place (one flat
    buffer): each rank's share becomes the whole gradient, as JAX's
    transpose of a replicated ``P()`` input gives it."""
    leaves = [p for p in param_leaves(params) if p.grad is not None]
    if not leaves:
        return
    flat = _all_reduce(mesh, torch.cat([p.grad.reshape(-1) for p in leaves]), "grad_sum")
    for p, chunk in zip(leaves, flat.split([p.numel() for p in leaves])):
        p.grad.copy_(chunk.view_as(p.grad))


# ----------------------------------------------------------------------
# Sharded building blocks
# ----------------------------------------------------------------------


def gather_nodes(mesh: GraphMesh, x_shard: torch.Tensor, idx_global: torch.Tensor) -> torch.Tensor:
    """Edge-side gather of node features: all-gather, then a local row
    gather. [N/D, F], [E/D] -> [E/D, F]."""
    return all_gather(mesh, x_shard).index_select(0, idx_global)


def scatter_nodes(mesh: GraphMesh, msg: torch.Tensor, idx_global: torch.Tensor,
                  num_nodes_padded: int) -> torch.Tensor:
    """Edge-side scatter back to node shards: local full-range partial
    segment-sum, then reduce-scatter. [E/D, F], [E/D] -> [N/D, F]."""
    return reduce_scatter(mesh, segment_sum(msg, idx_global, num_nodes_padded))


def halo_exchange(mesh: GraphMesh, x_loc: torch.Tensor, send_idx: torch.Tensor,
                  caps: Tuple[int, ...], hops: Tuple[int, ...]) -> torch.Tensor:
    """[n_loc, F] -> [n_loc + sum(caps), F]: local rows followed by one
    received block per active ring-hop distance. One shift per hop moves
    only each neighbour's boundary rows; backward is the reverse shift."""
    parts = [x_loc]
    for ki, k in enumerate(hops):
        send = x_loc.index_select(0, send_idx[ki, : caps[ki]])
        parts.append(ppermute(mesh, k + 1, send, kind=f"halo_ppermute+{k + 1}")[0])
    return torch.cat(parts, dim=0)


def ring_attention(mesh: GraphMesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor) -> torch.Tensor:
    """Exact global attention over ALL nodes of a sharded graph — ring
    attention. K/V blocks (and the block's mask) rotate one place around
    the ring per step while each rank keeps online-softmax accumulators
    (running max m, denominator l, output o), so no rank materializes the
    full [N, N] scores or the gathered K/V. D - 1 (compute, rotate) steps,
    then the epilogue compute on the last block, with no trailing hop.
    q, k, v: [n_loc, H, Dh]; kv_mask: [n_loc] bool. Returns [n_loc, H, Dh]."""
    scale = q.shape[-1] ** -0.5
    neg = torch.finfo(q.dtype).min
    m = torch.full_like(q[..., 0], neg)  # [n_loc, H]
    l = torch.zeros_like(q[..., 0])
    o = torch.zeros_like(q)

    def accumulate(m, l, o, k, v, kv_mask):
        s = torch.einsum("qhd,khd->qhk", q * scale, k)
        s = torch.where(kv_mask[None, None, :], s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        # masked columns contribute exp(neg - m) ~ 0 but force exact 0
        p = torch.where(kv_mask[None, None, :], p, 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("qhk,khd->qhd", p, v)
        return m_new, l, o

    for _ in range(mesh.size - 1):
        m, l, o = accumulate(m, l, o, k, v, kv_mask)
        k, v = ppermute(mesh, 1, k, v, kind="ring_ppermute+1")
        (kv_mask,) = _shift(mesh, 1, [kv_mask], "ring_ppermute+1")
    m, l, o = accumulate(m, l, o, k, v, kv_mask)
    return o / torch.clamp(l[..., None], min=1e-20)


def _dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_mask: torch.Tensor) -> torch.Tensor:
    """Dense masked softmax attention — the exact math ring attention
    reproduces blockwise."""
    s = torch.einsum("qhd,khd->qhk", q * q.shape[-1] ** -0.5, k)
    s = torch.where(kv_mask[None, None, :], s, torch.finfo(s.dtype).min)
    return torch.einsum("qhk,khd->qhd", torch.softmax(s, dim=-1), v)


# ----------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------


def init_params(
    generator: torch.Generator,
    in_dim: int,
    hidden: int,
    num_layers: int,
    num_gaussians: int,
    attn_heads: int = 0,
    device=None,
) -> Dict:
    """``{"embed", "filter_i", "update_i", ["attn_i": {q, k, v, out}],
    "readout"}``, each ``{"w": [in, out], "b": [out]}`` with
    ``w ~ N(0, 1) / sqrt(in)`` drawn from ``generator`` in that order and
    ``b = 0``; leaf tensors on ``device`` that require grad."""

    def dense(fan_in, fan_out):
        w = torch.randn(fan_in, fan_out, generator=generator) / float(np.sqrt(fan_in))
        return {"w": w.to(device).requires_grad_(),
                "b": torch.zeros(fan_out, device=device, requires_grad=True)}

    params: Dict = {"embed": dense(in_dim, hidden)}
    for i in range(num_layers):
        params[f"filter_{i}"] = dense(num_gaussians, hidden)
        params[f"update_{i}"] = dense(hidden, hidden)
        if attn_heads:
            params[f"attn_{i}"] = {nm: dense(hidden, hidden) for nm in ("q", "k", "v", "out")}
    params["readout"] = dense(hidden, 1)
    return params


def params_from_jax(tree: Dict, device=None) -> Dict:
    """The JAX package's ``init_params`` tree (numpy arrays) as the
    port's: the same nesting, f32 leaf tensors on ``device`` that require
    grad. ``w`` keeps JAX's ``[in, out]`` layout (``_dense`` is
    ``x @ w + b`` in both), so nothing is transposed."""
    if hasattr(tree, "items"):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device).requires_grad_()


def param_items(params: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` in sorted key order (``jax.tree_util``'s order for
    dicts), paths joined by ``/``."""
    out = []
    for k in sorted(params):
        v = params[k]
        path = f"{prefix}{k}"
        out.extend(param_items(v, path + "/") if isinstance(v, dict) else [(path, v)])
    return out


def param_leaves(params: Dict) -> List[torch.Tensor]:
    return [t for _, t in param_items(params)]


def _dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


# ----------------------------------------------------------------------
# The model: SchNet-style CFConv layers, optional global attention,
# node-energy readout
# ----------------------------------------------------------------------


def _mpnn(params: Dict, x: torch.Tensor, vec: torch.Tensor, edge_mask: torch.Tensor,
          node_mask: torch.Tensor, sender_rows: Callable, aggregate: Callable,
          attend: Callable, *, cutoff: float, num_gaussians: int, num_layers: int,
          attn_heads: int) -> torch.Tensor:
    """The body every scheme shares, on this rank's rows: the sum of its
    nodes' energies. ``sender_rows(h)`` gives each edge's sender row,
    ``aggregate(msg)`` sums messages into this rank's nodes, ``attend(q,
    k, v)`` is global attention over the heads."""
    h = _dense(params["embed"], x)
    d = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
    rbf = gaussian_smearing(d, 0.0, cutoff, num_gaussians)
    w_cut = (cosine_cutoff(d, cutoff) * edge_mask.to(h.dtype))[:, None]
    nmask = node_mask.to(h.dtype)[:, None]
    for i in range(num_layers):
        filt = F.silu(_dense(params[f"filter_{i}"], rbf)) * w_cut
        agg = aggregate(sender_rows(h) * filt)
        h = h + F.silu(_dense(params[f"update_{i}"], agg))
        if attn_heads:
            ap = params[f"attn_{i}"]
            n, hidden = h.shape

            def heads(p):
                return _dense(p, h).reshape(n, attn_heads, hidden // attn_heads)

            attn = attend(heads(ap["q"]), heads(ap["k"]), heads(ap["v"]))
            h = h + _dense(ap["out"], attn.reshape(n, hidden)) * nmask
    node_e = _dense(params["readout"], h)[:, 0]
    return torch.sum(node_e * node_mask.to(node_e.dtype))


def sharded_mpnn_forward(
    params: Dict,
    shards: GraphShards,
    mesh: GraphMesh,
    *,
    cutoff: float,
    num_gaussians: int,
    num_layers: int,
    attn_heads: int = 0,
) -> torch.Tensor:
    """Total energy of one sharded graph (``shards`` is this rank's
    ``GraphShards.local`` block): SchNet-style CFConv layers + node-energy
    readout, node and edge tensors sharded over the axis, messages by
    all-gather / reduce-scatter. With ``attn_heads`` > 0 each layer adds a
    GPS-style global attention branch by ``ring_attention``.

    Returns the replicated scalar on every rank; differentiable in the
    positions (forces through the collectives) and the parameters (each
    rank's share: ``sum_gradients_``)."""
    snd, rcv = shards.senders, shards.receivers
    vec = gather_nodes(mesh, shards.pos, snd) - gather_nodes(mesh, shards.pos, rcv)
    e_loc = _mpnn(
        params, shards.x, vec, shards.edge_mask, shards.node_mask,
        lambda h: gather_nodes(mesh, h, snd),
        lambda msg: scatter_nodes(mesh, msg, rcv, shards.num_nodes_padded),
        lambda q, k, v: ring_attention(mesh, q, k, v, shards.node_mask),
        cutoff=cutoff, num_gaussians=num_gaussians, num_layers=num_layers,
        attn_heads=attn_heads)
    return psum(mesh, e_loc)


def halo_mpnn_forward(
    params: Dict,
    shards: HaloShards,
    mesh: GraphMesh,
    *,
    cutoff: float,
    num_gaussians: int,
    num_layers: int,
    attn_heads: int = 0,
) -> torch.Tensor:
    """``sharded_mpnn_forward`` semantics with halo exchange instead of
    all-gather (``shards`` is this rank's ``HaloShards.local`` block): per
    layer each rank materializes n_loc + halo rows (``halo_rows``), never
    the full [N, F] array, and the message sum is LOCAL (edges live with
    their receiver). Global attention still rides ``ring_attention``.
    Returns the replicated scalar; differentiable."""
    snd, rcv = shards.senders_halo, shards.receivers_local

    def exchange(arr):
        return halo_exchange(mesh, arr, shards.send_idx, shards.caps, shards.hops)

    pos_h = exchange(shards.pos)
    vec = pos_h.index_select(0, snd) - pos_h.index_select(0, rcv)
    e_loc = _mpnn(
        params, shards.x, vec, shards.edge_mask, shards.node_mask,
        lambda h: exchange(h).index_select(0, snd),
        lambda msg: segment_sum(msg, rcv, shards.n_loc),
        lambda q, k, v: ring_attention(mesh, q, k, v, shards.node_mask),
        cutoff=cutoff, num_gaussians=num_gaussians, num_layers=num_layers,
        attn_heads=attn_heads)
    return psum(mesh, e_loc)


def reference_mpnn_forward(
    params: Dict,
    x: torch.Tensor,
    pos: torch.Tensor,
    node_mask: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    edge_mask: torch.Tensor,
    *,
    cutoff: float,
    num_gaussians: int,
    num_layers: int,
    attn_heads: int = 0,
) -> torch.Tensor:
    """Single-process computation of the same model on the whole padded
    graph (the differential reference), with dense masked softmax
    attention."""
    vec = pos.index_select(0, senders) - pos.index_select(0, receivers)
    return _mpnn(
        params, x, vec, edge_mask, node_mask,
        lambda h: h.index_select(0, senders),
        lambda msg: segment_sum(msg, receivers, x.shape[0]),
        lambda q, k, v: _dense_attention(q, k, v, node_mask),
        cutoff=cutoff, num_gaussians=num_gaussians, num_layers=num_layers,
        attn_heads=attn_heads)
