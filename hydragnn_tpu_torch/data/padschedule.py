"""Bin-packed batch forming, the shared spec schedules of the stacked
schemes, and the superstep grouping.

Counterpart of ``hydragnn_tpu/data/padschedule.py``: the packing half
(``OpenBin``, ``PackPlanner``, ``pack_epoch_ffd``, ``fit_pack_budgets``
and their helpers), the unpacked specs the loader pads to
(``ladder_spec``, ``worst_case_spec_from_sizes``), the ``packing:
"auto"`` decisions (``packing_beats_ladder`` and the dp scheme's
``dp_packing_beats_schedule``), the superstep grouping
(``superstep_groups``, ``auto_superstep_k``), and the dp half: the
per-step shared specs of the dp and multibranch schemes
(``PadSpecSchedule``, ``dp_spec_schedule``, ``slot_spec_schedule``), the
device-coordinated packer (``pack_epoch_ffd_dp``) and the step-level
fold of a plan (``dp_step_plan``). Device-free size arithmetic, copied
so that fitted budgets, packed bins, pad specs, schedules, decisions and
groups match the JAX package's bit for bit. Where the JAX package stacks
one step's sub-batches into a ``[D, ...]`` array, the port's ranks each
take their own slot of the step (``parallel/dp.DPLoader``), so the
shared spec keeps every rank's step at one shape and the ranks' steps
in lockstep.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import PackSpec, PadSpec, bucket_size

# Bound on the size sample the budget fit simulates (the JAX package's
# HYDRAGNN_TPU_PACKING_FIT_SAMPLE default).
FIT_SAMPLE = 50000
# Shuffled epochs the slack candidates are simulated over.
SIM_EPOCHS = 2
# Distinct ladder shapes "auto" padding accepts (the JAX package's
# HYDRAGNN_TPU_MAX_PAD_BUCKETS default).
MAX_PAD_BUCKETS = 6
# Executed/real ratio packing must reach against the unpacked baseline's
# for "auto" to pack: a 3% padding-waste win.
PACK_MARGIN = 0.97


def epoch_batch_indices(
    n: int,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int,
    epoch: int,
    num_samples: Optional[int] = None,
    drop_last: bool = False,
) -> Iterator[np.ndarray]:
    """Index arrays of each batch of one epoch, keyed by (seed, epoch).
    ``num_samples`` draws that many indices instead of a permutation
    (with replacement when it exceeds ``n``); ``drop_last`` drops a
    short last batch."""
    rng = np.random.default_rng((seed, epoch))
    if num_samples is not None:
        order = rng.choice(n, size=num_samples, replace=num_samples > n)
    else:
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield idx


def ladder_spec(tot_nodes: int, tot_edges: int, n_graphs: int) -> PadSpec:
    """Bucketed per-batch PadSpec from size totals (``PadSpec.for_samples``
    arithmetic without the samples)."""
    return PadSpec(
        num_nodes=bucket_size(int(tot_nodes) + 1),
        num_edges=bucket_size(max(int(tot_edges), 1)),
        num_graphs=int(n_graphs) + 1,
    )


def ladder_spec_keys(
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int,
    epochs: int,
    num_samples: Optional[int] = None,
    drop_last: bool = False,
) -> set:
    """Distinct (nodes, edges, graphs) ladder keys over the first
    ``epochs`` epochs' batches (``epoch_batch_indices``' order)."""
    keys = set()
    for ep in range(epochs):
        for idx in epoch_batch_indices(
            len(node_sizes), batch_size, shuffle=shuffle, seed=seed, epoch=ep,
            num_samples=num_samples, drop_last=drop_last,
        ):
            spec = ladder_spec(
                int(node_sizes[idx].sum()), int(edge_sizes[idx].sum()), len(idx)
            )
            keys.add((spec.num_nodes, spec.num_edges, spec.num_graphs))
    return keys


def worst_case_spec_from_sizes(
    node_sizes: np.ndarray, edge_sizes: np.ndarray, batch_size: int
) -> PadSpec:
    """Worst-case bucketed spec over any batch of ``batch_size`` samples
    (nodes and edges bound independently)."""
    node_top = sorted((int(c) for c in node_sizes), reverse=True)
    edge_top = sorted((int(c) for c in edge_sizes), reverse=True)
    return PadSpec(
        num_nodes=bucket_size(sum(node_top[:batch_size]) + 1),
        num_edges=bucket_size(max(sum(edge_top[:batch_size]), 1)),
        num_graphs=batch_size + 1,
    )


def batch_size_rows(
    node_sizes: np.ndarray, edge_sizes: np.ndarray, index_batches
) -> np.ndarray:
    """``[n_batches, 3]`` int rows of (nodes with one pad slot, edges,
    graphs with one pad slot) per batch: the row every schedule and
    loader shares."""
    rows = [
        (int(node_sizes[idx].sum()) + 1, int(edge_sizes[idx].sum()), len(idx) + 1)
        for idx in index_batches
    ]
    return np.asarray(rows, np.int64).reshape(-1, 3)


def shard_for_process(n_total: int, process_index: int, process_count: int) -> range:
    """Contiguous block partition of sample indices per process (the JAX
    package's ``data/diststore.shard_for_process``)."""
    base = n_total // process_count
    rem = n_total % process_count
    start = process_index * base + min(process_index, rem)
    stop = start + base + (1 if process_index < rem else 0)
    return range(start, stop)


class PadSpecSchedule:
    """Per-(epoch, batch index) shared PadSpecs with a deterministic
    clamp. ``rows_fn(epoch)`` gives ``[n_batches, 3]`` targets already
    maxed over the sub-batches that share a step; the schedule buckets
    them up the ladder, counts the distinct keys, and clamps to
    ``worst_spec`` for good once the count exceeds ``2 * bucket_limit``,
    replayed in epoch order so every rank clamps at the same step."""

    def __init__(self, rows_fn: Callable[[int], np.ndarray], worst_spec: PadSpec,
                 bucket_limit: int):
        self._rows_fn = rows_fn
        self.worst_spec = worst_spec
        self._limit = int(bucket_limit)
        self._epochs: List[List[PadSpec]] = []
        self._seen: set = set()
        self._clamped = False

    @staticmethod
    def _key(row) -> tuple:
        n, e, g = (int(v) for v in row)
        return (bucket_size(n), bucket_size(max(e, 1)), g)

    def _extend_through(self, epoch: int) -> None:
        while len(self._epochs) <= epoch:
            specs: List[PadSpec] = []
            for row in self._rows_fn(len(self._epochs)):
                if not self._clamped:
                    key = self._key(row)
                    self._seen.add(key)
                    if len(self._seen) > 2 * self._limit:
                        self._clamped = True
                if self._clamped:
                    specs.append(self.worst_spec)
                else:
                    specs.append(PadSpec(num_nodes=key[0], num_edges=key[1],
                                         num_graphs=key[2]))
            self._epochs.append(specs)

    def spec(self, epoch: int, batch_index: int) -> PadSpec:
        self._extend_through(epoch)
        specs = self._epochs[epoch]
        if batch_index >= len(specs):
            # only past the shared step count: the worst spec is safe
            return self.worst_spec
        return specs[batch_index]

    def distinct_keys(self, epochs: int = 4) -> set:
        """The distinct bucketed keys of the first ``epochs`` epochs, by
        simulation (the clamp state is untouched)."""
        return {self._key(row) for e in range(epochs) for row in self._rows_fn(e)}

    def ladder_is_small(self, epochs: int = 4) -> bool:
        return len(self.distinct_keys(epochs)) <= self._limit

    def fingerprint(self, epochs: int = 2) -> List[int]:
        """A small integer summary that ranks compare to agree."""
        keys = self.distinct_keys(epochs)
        return [len(keys), sum(k[0] + k[1] + k[2] for k in keys)]


def dp_spec_schedule(
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    *,
    batch_size: int,
    n_procs: int,
    steps_group: int,
    seed: int,
    shuffle: bool,
    bucket_limit: Optional[int] = None,
) -> PadSpecSchedule:
    """The dp scheme's schedule, from the FULL dataset's sizes so every
    rank computes the same one: contiguous equal-size process shards
    (``shard_for_process`` truncated to equal length), each process's
    epoch order (one seed everywhere), and ``steps_group`` consecutive
    local batches per step. Step t's spec covers batches ``[t *
    steps_group, (t + 1) * steps_group)`` of every process."""
    node_sizes = np.asarray(node_sizes, dtype=np.int64)
    edge_sizes = np.asarray(edge_sizes, dtype=np.int64)
    n_total = len(node_sizes)
    if n_procs > 1:
        equal = n_total // n_procs
        shards = []
        for p in range(n_procs):
            idx = np.fromiter(shard_for_process(n_total, p, n_procs), dtype=np.int64)[:equal]
            shards.append((node_sizes[idx], edge_sizes[idx]))
    else:
        shards = [(node_sizes, edge_sizes)]

    def rows_fn(epoch: int) -> np.ndarray:
        per_proc = [
            batch_size_rows(ns, es, epoch_batch_indices(
                len(ns), batch_size, shuffle=shuffle, seed=seed, epoch=epoch))
            for ns, es in shards
        ]
        gmax = np.stack(per_proc).max(axis=0)
        for t0 in range(0, len(gmax), steps_group):
            gmax[t0 : t0 + steps_group] = gmax[t0 : t0 + steps_group].max(axis=0)
        return gmax

    worst = worst_case_spec_from_sizes(node_sizes, edge_sizes, batch_size)
    return PadSpecSchedule(rows_fn, worst,
                           MAX_PAD_BUCKETS if bucket_limit is None else bucket_limit)


def slot_spec_schedule(loaders: Sequence, bucket_limit: Optional[int] = None
                       ) -> PadSpecSchedule:
    """The multibranch scheme's schedule: one batch per device slot per
    step, so step t's spec is the max over every slot's t-th batch.
    Every rank builds all slot loaders, so the schedule agrees."""

    def rows_fn(epoch: int) -> np.ndarray:
        per_slot = [ld.epoch_size_rows(epoch) for ld in loaders]
        n_steps = min(len(r) for r in per_slot)
        return np.stack([r[:n_steps] for r in per_slot]).max(axis=0)

    worsts = [worst_case_spec_from_sizes(*dataset_size_arrays(ld.dataset), ld.batch_size)
              for ld in loaders]
    worst = PadSpec(num_nodes=max(w.num_nodes for w in worsts),
                    num_edges=max(w.num_edges for w in worsts),
                    num_graphs=max(w.num_graphs for w in worsts))
    return PadSpecSchedule(rows_fn, worst,
                           MAX_PAD_BUCKETS if bucket_limit is None else bucket_limit)


def dataset_size_arrays(dataset) -> tuple:
    """Per-sample (node, edge) counts as int64 arrays. A container with a
    header index (``BinDataset.sample_sizes``) answers without reading a
    sample; otherwise one scan, cached on the dataset object."""
    sizes = getattr(dataset, "sample_sizes", None)
    if callable(sizes):
        n, e = sizes()
        return np.asarray(n, dtype=np.int64), np.asarray(e, dtype=np.int64)
    cached = getattr(dataset, "_cached_sample_sizes", None)
    if cached is not None:
        return cached
    n = np.array([s.num_nodes for s in dataset], dtype=np.int64)
    e = np.array([s.num_edges for s in dataset], dtype=np.int64)
    try:
        dataset._cached_sample_sizes = (n, e)
    except (AttributeError, TypeError):
        pass  # plain lists and tuples cannot carry the cache
    return n, e


def _round8(v: float) -> int:
    return int(int(np.ceil(float(v) / 8.0)) * 8)


def _fit_sample(
    node_sizes: np.ndarray, edge_sizes: np.ndarray, seed: int
) -> tuple:
    """Deterministic bounded subsample of the size histogram for the
    fitting simulation (capacities are ratios of means)."""
    n = len(node_sizes)
    if n <= FIT_SAMPLE:
        return node_sizes, edge_sizes
    rng = np.random.default_rng((int(seed), n))
    pick = rng.choice(n, size=FIT_SAMPLE, replace=False)
    return node_sizes[pick], edge_sizes[pick]


def _budget_from_caps(
    cap_n: int, cap_e: int, cap_g: int, max_n: int, max_e: int
) -> PackSpec:
    """PackSpec with sizes rounded to 8; capacities never fall below the
    largest single graph."""
    cap_n = max(int(cap_n), int(max_n))
    cap_e = max(int(cap_e), int(max_e), 1)
    return PackSpec(
        num_nodes=_round8(cap_n + 1),
        num_edges=_round8(cap_e),
        num_graphs=max(int(cap_g), 1) + 1,
    )


class OpenBin:
    """One bin a ``PackPlanner`` is filling: remaining capacities under
    the largest budget, member tags, running real-size totals and a
    caller-owned ``meta`` dict."""

    __slots__ = (
        "node_room",
        "edge_room",
        "graph_room",
        "tags",
        "tot_nodes",
        "tot_edges",
        "meta",
    )

    def __init__(self, node_room: int, edge_room: int, graph_room: int):
        self.node_room = int(node_room)
        self.edge_room = int(edge_room)
        self.graph_room = int(graph_room)
        self.tags: List = []
        self.tot_nodes = 0
        self.tot_edges = 0
        self.meta: dict = {}


class PackPlanner:
    """Incremental first-fit packer over a nested ``PackSpec`` budget
    set: items go to the first open bin with room under the largest
    budget; beyond ``open_window`` open bins the fullest is frozen out
    of the scan (``take_frozen``); ``assign_budget`` downshifts a
    finished bin to the smallest budget that holds it."""

    def __init__(self, budgets: Sequence[PackSpec], open_window: int = 256):
        self.budgets = sorted(
            budgets, key=lambda b: (b.num_nodes, b.num_edges), reverse=True
        )
        if not self.budgets:
            raise ValueError("PackPlanner needs at least one budget")
        self.big = self.budgets[0]
        for b in self.budgets[1:]:
            if (
                b.num_edges > self.big.num_edges
                or b.num_graphs > self.big.num_graphs
                or b.num_nodes > self.big.num_nodes
            ):
                raise ValueError(
                    f"pack budgets must be nested under the largest; "
                    f"{b} exceeds {self.big} in some dimension"
                )
        self.open_window = max(int(open_window), 1)
        self._open: List[OpenBin] = []
        self._frozen: List[OpenBin] = []

    def fits(self, n_nodes: int, n_edges: int) -> bool:
        """Whether a single item can ever be packed."""
        return self.big.fits(int(n_nodes), int(n_edges), 1)

    @property
    def open_bins(self) -> List[OpenBin]:
        return self._open

    def add(self, tag, n_nodes: int, n_edges: int) -> OpenBin:
        """Place one item first-fit; returns the bin it landed in."""
        n, e = int(n_nodes), int(n_edges)
        placed = None
        for b in self._open:
            if b.node_room >= n and b.edge_room >= e and b.graph_room >= 1:
                placed = b
                break
        if placed is None:
            if not self.fits(n, e):
                raise ValueError(
                    f"item ({n} nodes, {e} edges) exceeds the largest "
                    f"pack budget {self.big}"
                )
            placed = OpenBin(
                self.big.capacity_nodes,
                self.big.capacity_edges,
                self.big.capacity_graphs,
            )
            self._open.append(placed)
        placed.node_room -= n
        placed.edge_room -= e
        placed.graph_room -= 1
        placed.tot_nodes += n
        placed.tot_edges += e
        placed.tags.append(tag)
        if len(self._open) > self.open_window:
            full = min(
                range(len(self._open)),
                key=lambda k: self._open[k].node_room,
            )
            self._frozen.append(self._open.pop(full))
        return placed

    def pop(self, b: OpenBin) -> None:
        """Remove one bin from the scan (no-op if already frozen out)."""
        try:
            self._open.remove(b)
        except ValueError:
            try:
                self._frozen.remove(b)
            except ValueError:
                pass

    def take_frozen(self) -> List[OpenBin]:
        out, self._frozen = self._frozen, []
        return out

    def drain(self) -> List[OpenBin]:
        """Every remaining bin (frozen first, then open), clearing the
        planner."""
        out = self._frozen + self._open
        self._open, self._frozen = [], []
        return out

    def assign_budget(
        self, tot_nodes: int, tot_edges: int, n_graphs: int
    ) -> PackSpec:
        """Smallest fitted budget holding the totals."""
        spec = self.big
        for cand in self.budgets:  # descending: last fitting = smallest
            if cand.fits(int(tot_nodes), int(tot_edges), int(n_graphs)):
                spec = cand
        return spec


def pack_epoch_ffd(
    order: np.ndarray,
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    budgets: Sequence[PackSpec],
    open_window: int = 256,
) -> List[tuple]:
    """First-fit-decreasing pack of one epoch's order into budget bins:
    ``[(idx, PackSpec), ...]`` in epoch order."""
    planner = PackPlanner(budgets, open_window=open_window)
    order = np.asarray(order, dtype=np.int64)
    n_of = node_sizes[order]
    by_size = np.argsort(-n_of, kind="stable")
    for pos in by_size:
        i = int(order[pos])
        n, e = int(node_sizes[i]), int(edge_sizes[i])
        if not planner.fits(n, e):
            raise ValueError(
                f"graph {i} ({n} nodes, {e} edges) exceeds the "
                f"largest pack budget {planner.big}"
            )
        planner.add(int(pos), n, e)
    out = []
    for b in sorted(planner.drain(), key=lambda b: min(b.tags)):
        members = sorted(b.tags)
        idx = order[members]
        tot_n = int(node_sizes[idx].sum())
        tot_e = int(edge_sizes[idx].sum())
        out.append(
            (idx, planner.assign_budget(tot_n, tot_e, len(idx)))
        )
    return out


def fit_pack_budgets(
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    batch_size: int,
    *,
    max_budgets: int = 2,
    slack: Optional[float] = None,
    max_graphs: Optional[int] = None,
    seed: int = 0,
    with_meta: bool = False,
) -> "List[PackSpec] | tuple":
    """Fit the budget set the packer fills from the size histogram: a
    primary budget sized for ``len / batch_size`` bins with a small
    capacity ``slack`` (simulated over ``SIM_EPOCHS`` shuffled epochs
    for a few candidates when None, the one with the least
    executed/real size kept), plus ``max_budgets - 1`` halved
    sub-budgets for tail bins. ``max_graphs`` caps a bin's graph count
    (default 2x ``batch_size``). ``with_meta`` returns ``(budgets,
    {"slack", "waste"})``: the chosen slack and its simulated
    executed/real (nodes + edges) ratio."""
    node_sizes = np.asarray(node_sizes, dtype=np.int64)
    edge_sizes = np.asarray(edge_sizes, dtype=np.int64)
    if len(node_sizes) == 0:
        raise ValueError("cannot fit pack budgets over an empty dataset")
    max_n = int(node_sizes.max())
    max_e = int(edge_sizes.max())
    node_sizes, edge_sizes = _fit_sample(node_sizes, edge_sizes, seed)
    n = len(node_sizes)
    total_n = int(node_sizes.sum())
    total_e = int(edge_sizes.sum())
    min_n = max(int(node_sizes.min()), 1)
    k = max(1, int(round(n / float(batch_size))))

    def _budget_set(s: float) -> List[PackSpec]:
        cap_n = int(np.ceil(total_n / k * s))
        cap_e = int(np.ceil(total_e / k * s))
        cap_g = (
            int(max_graphs)
            if max_graphs is not None
            else min(cap_n // min_n, 2 * int(batch_size))
        )
        cap_g = max(cap_g, 1)
        out = [_budget_from_caps(cap_n, cap_e, cap_g, max_n, max_e)]
        for _ in range(max(int(max_budgets), 1) - 1):
            cap_n //= 2
            cap_e //= 2
            cap_g = max(cap_g // 2, 1)
            cand = _budget_from_caps(cap_n, cap_e, cap_g, max_n, max_e)
            if cand != out[-1]:
                out.append(cand)
        return out

    def _waste(budgets: List[PackSpec]) -> float:
        executed = real = 0.0
        for ep in range(SIM_EPOCHS):
            order = np.concatenate(
                [
                    idx
                    for idx in epoch_batch_indices(
                        n, batch_size, shuffle=True, seed=seed, epoch=ep
                    )
                ]
            )
            for idx, spec in pack_epoch_ffd(
                order, node_sizes, edge_sizes, budgets
            ):
                executed += spec.num_nodes + spec.num_edges
                real += float(
                    node_sizes[idx].sum() + edge_sizes[idx].sum()
                )
        return executed / max(real, 1.0)

    if slack is not None:
        cand = _budget_set(float(slack))
        if with_meta:
            return cand, {"slack": float(slack), "waste": _waste(cand)}
        return cand
    best = None
    best_w = float("inf")
    best_s = None
    for s in (1.01, 1.02, 1.04, 1.06, 1.1):
        cand = _budget_set(s)
        w = _waste(cand)
        if w < best_w:
            best, best_w, best_s = cand, w, s
    if with_meta:
        return best, {"slack": best_s, "waste": best_w}
    return best


def packing_beats_ladder(
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    batch_size: int,
    *,
    seed: int = 0,
    **fit_kw,
) -> Optional[tuple]:
    """The ``packing: "auto"`` decision: fit budgets and return
    ``(budgets, slack)`` when the packed executed/real (nodes + edges)
    ratio is at most ``PACK_MARGIN`` times the unpacked baseline's, else
    None. The baseline is what the run's train loader
    (``fixed_pad="auto"``) would do: the ladder while the first four
    shuffled epochs give at most ``MAX_PAD_BUCKETS`` distinct shapes,
    else one worst-case spec. Both sides are simulated over
    ``SIM_EPOCHS`` shuffled epochs; the packed side is the fit's own."""
    node_sizes = np.asarray(node_sizes, dtype=np.int64)
    edge_sizes = np.asarray(edge_sizes, dtype=np.int64)
    if len(node_sizes) == 0:
        return None
    budgets, meta = fit_pack_budgets(
        node_sizes, edge_sizes, batch_size, seed=seed, with_meta=True, **fit_kw
    )
    ladder_ok = len(ladder_spec_keys(
        node_sizes, edge_sizes, batch_size, shuffle=True, seed=seed, epochs=4
    )) <= MAX_PAD_BUCKETS
    worst = worst_case_spec_from_sizes(node_sizes, edge_sizes, batch_size)
    baseline_exe = real = 0.0
    for ep in range(SIM_EPOCHS):
        for idx in epoch_batch_indices(
            len(node_sizes), batch_size, shuffle=True, seed=seed, epoch=ep
        ):
            tot_n = int(node_sizes[idx].sum())
            tot_e = int(edge_sizes[idx].sum())
            spec = ladder_spec(tot_n, tot_e, len(idx)) if ladder_ok else worst
            baseline_exe += spec.num_nodes + spec.num_edges
            real += float(tot_n + tot_e)
    if meta["waste"] <= (baseline_exe / max(real, 1.0)) * PACK_MARGIN:
        return budgets, meta["slack"]
    return None


def pack_epoch_ffd_dp(
    order: np.ndarray,
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    budgets: Sequence[PackSpec],
    n_shards: int,
    open_window: int = 256,
) -> List[tuple]:
    """Device-coordinated FFD pack for the dp scheme: one epoch packed
    into budget bins arranged so every consecutive ``n_shards`` bins
    (one optimizer step, one bin per data slot) share one budget and the
    plan's length is a multiple of ``n_shards``; no sample is dropped or
    repeated. As in the JAX package: the positions are packed in the
    canonical (-nodes, -edges, position) order (so the bins' size
    structure, and the balance's feasibility, depend on the size
    multiset only); budget groups too small to fill a step merge into
    the largest budget's group; a group's bin count is balanced up to a
    multiple of ``n_shards`` by splitting its largest-membership bin;
    steps are emitted largest budget first, each group's bins by their
    earliest member's epoch position. Raises ``ValueError`` when the
    epoch holds fewer graphs than ``n_shards`` or no split can balance
    a group."""
    n_shards = int(n_shards)
    if n_shards <= 1:
        return pack_epoch_ffd(order, node_sizes, edge_sizes, budgets, open_window)
    order = np.asarray(order, dtype=np.int64)
    if len(order) < n_shards:
        raise ValueError(
            f"cannot coordinate packed bins across {n_shards} devices: "
            f"the epoch holds only {len(order)} graphs"
        )
    n_of = np.asarray(node_sizes, dtype=np.int64)[order]
    e_of = np.asarray(edge_sizes, dtype=np.int64)[order]
    canon = np.lexsort((np.arange(len(order)), -e_of, -n_of)).astype(np.int64)
    bins = pack_epoch_ffd(canon, n_of, e_of, budgets, open_window)
    big = sorted(budgets, key=lambda b: (b.num_nodes, b.num_edges), reverse=True)[0]
    groups: dict = {}
    for idx, spec in bins:
        key = (spec.num_nodes, spec.num_edges, spec.num_graphs)
        groups.setdefault(key, {"spec": spec, "bins": []})["bins"].append(list(idx))
    big_key = (big.num_nodes, big.num_edges, big.num_graphs)

    def _graphs(g) -> int:
        return sum(len(b) for b in g["bins"])

    def _target(g) -> int:
        return -(-len(g["bins"]) // n_shards) * n_shards

    for key in sorted(k for k in groups if k != big_key):
        g = groups[key]
        if _graphs(g) < max(_target(g), n_shards):
            groups.setdefault(big_key, {"spec": big, "bins": []})["bins"].extend(g["bins"])
            del groups[key]
    bg = groups.get(big_key)
    if bg is not None and _graphs(bg) < max(_target(bg), n_shards):
        for key in sorted((k for k in groups if k != big_key), reverse=True):
            bg["bins"].extend(groups[key]["bins"])
            del groups[key]
            if _graphs(bg) >= max(_target(bg), n_shards):
                break

    def _split(members: List[int]) -> tuple:
        by_size = sorted(members, key=lambda p: (-int(n_of[p]), p))
        return by_size[0::2], by_size[1::2]

    for key in sorted(groups):
        g = groups[key]
        while len(g["bins"]) % n_shards:
            splittable = [j for j, b in enumerate(g["bins"]) if len(b) >= 2]
            if not splittable:
                raise ValueError(
                    f"cannot balance packed bins across {n_shards} devices: every "
                    "remaining bin holds a single graph (graphs near budget capacity) "
                    "- use the spec-schedule former for this dataset"
                )
            j = max(splittable, key=lambda j: len(g["bins"][j]))
            a, b = _split(g["bins"].pop(j))
            g["bins"].extend([a, b])

    out: List[tuple] = []
    for key in sorted(groups, reverse=True):
        g = groups[key]
        for members in sorted(g["bins"], key=min):
            out.append((order[sorted(members)], g["spec"]))
    return out


def dp_step_plan(plan, n_shards: int) -> tuple:
    """Fold a flat epoch plan into step-level entries for ``n_shards``
    data slots: step t covers entries ``[t*D, (t+1)*D)``. Returns
    ``(steps, tail)``: one ``(t, spec)`` per full step (``spec`` when
    all D entries share one spec key, else None), and the trailing
    ``len(plan) % D`` flat entries (the masked remainder step)."""

    def _key(s):  # PadSpec or PackSpec (budgets carry no triplet dim)
        if s is None:
            return None
        return (s.num_nodes, s.num_edges, s.num_graphs, getattr(s, "num_triplets", None))

    plan = list(plan)
    d = max(int(n_shards), 1)
    n_full = len(plan) // d
    steps: List[tuple] = []
    for t in range(n_full):
        specs = [s for _, s in plan[t * d : (t + 1) * d]]
        key = _key(specs[0])
        same = key is not None and all(_key(s) == key for s in specs)
        steps.append((t, specs[0] if same else None))
    return steps, plan[n_full * d :]


def dp_packing_beats_schedule(
    node_sizes: np.ndarray,
    edge_sizes: np.ndarray,
    batch_size: int,
    n_shards: int,
    *,
    seed: int = 0,
    baseline: str = "auto",
    **fit_kw,
) -> Optional[tuple]:
    """The dp scheme's ``packing: "auto"`` decision: fit budgets and
    return ``(budgets, slack)`` when the coordinated packed plan
    (``pack_epoch_ffd_dp``, its balancing splits included) executes at
    most ``PACK_MARGIN`` times what the unpacked dp run would: every
    batch of a step padded to the step's shared bucketed spec, the
    remainder step completed with masked copies, and the whole schedule
    clamped to the worst case past twice ``MAX_PAD_BUCKETS`` distinct
    shapes (``baseline="auto"``; ``"ladder"``/``"worst"`` force a
    side). None when it does not, or when coordination is infeasible.
    The waste runs over the fit's bounded subsample, the clamp decision
    over the full arrays, as in the JAX package."""
    node_sizes = np.asarray(node_sizes, dtype=np.int64)
    edge_sizes = np.asarray(edge_sizes, dtype=np.int64)
    n_shards = max(int(n_shards), 1)
    if len(node_sizes) < n_shards:
        return None
    budgets, meta = fit_pack_budgets(
        node_sizes, edge_sizes, batch_size, seed=seed, with_meta=True, **fit_kw
    )
    ns, es = _fit_sample(node_sizes, edge_sizes, seed)
    n = len(ns)
    if n < n_shards:
        return None

    def _rows(ep, nodes, edges):
        rows = batch_size_rows(nodes, edges, epoch_batch_indices(
            len(nodes), batch_size, shuffle=True, seed=seed, epoch=ep))
        for t0 in range(0, len(rows), n_shards):
            rows[t0 : t0 + n_shards] = rows[t0 : t0 + n_shards].max(axis=0)
        return rows

    if baseline == "ladder":
        ladder_ok = True
    elif baseline == "worst":
        ladder_ok = False
    else:
        keys = {PadSpecSchedule._key(row) for ep in range(4)
                for row in _rows(ep, node_sizes, edge_sizes)}
        ladder_ok = len(keys) <= 2 * MAX_PAD_BUCKETS
    worst = worst_case_spec_from_sizes(ns, es, batch_size)
    base_exe = pack_exe = 0.0
    for ep in range(SIM_EPOCHS):
        rows = _rows(ep, ns, es)
        for gn, ge, _ in rows:
            if ladder_ok:
                base_exe += bucket_size(int(gn)) + bucket_size(max(int(ge), 1))
            else:
                base_exe += worst.num_nodes + worst.num_edges
        rem = (-len(rows)) % n_shards
        if rem:  # the masked copies completing the last step execute too
            gn, ge, _ = rows[-1]
            if ladder_ok:
                base_exe += rem * (bucket_size(int(gn)) + bucket_size(max(int(ge), 1)))
            else:
                base_exe += rem * (worst.num_nodes + worst.num_edges)
        order = np.concatenate(list(epoch_batch_indices(
            n, batch_size, shuffle=True, seed=seed, epoch=ep)))
        try:
            dp_plan = pack_epoch_ffd_dp(order, ns, es, budgets, n_shards)
        except ValueError:
            return None  # coordination infeasible: keep the schedule
        for _, spec in dp_plan:
            pack_exe += spec.num_nodes + spec.num_edges
    if pack_exe <= base_exe * PACK_MARGIN:
        return budgets, meta["slack"]
    return None


# ----------------------------------------------------------------------
# Superstep grouping: one epoch's (idx, spec) plan folded into runs of K
# consecutive same-spec batches, each run one K-step dispatch
# (train/loop.make_superstep_fn; on the card one CUDA-graph replay).
# ----------------------------------------------------------------------


def _spec_key(spec) -> tuple:
    return (
        spec.num_nodes,
        spec.num_edges,
        spec.num_graphs,
        spec.num_triplets,
    )


def superstep_groups(plan, k: int) -> List[list]:
    """Group one epoch's ``[(idx, spec), ...]`` plan into superstep
    groups: each group is a list of consecutive same-spec plan entries
    of length exactly ``k`` (one K-step dispatch) or length 1 (a plain
    single-step batch).

    Maximal same-spec runs are cut into full ``k``-chunks as they
    accumulate; a run's remainder (< k entries) is emitted as
    singletons, so the set of step shapes stays bounded at {K steps per
    spec} plus {one step per spec}. Entries with ``spec=None`` are never
    grouped. ``k <= 1`` returns every entry as a singleton: the plan's
    batch order and content are always preserved, only the grouping
    boundaries change."""
    k = int(k)
    groups: List[list] = []
    run: List[tuple] = []
    run_key = None

    def _flush():
        # remainder of a broken run: singletons (see docstring)
        groups.extend([e] for e in run)
        run.clear()

    for entry in plan:
        spec = entry[1]
        key = None if spec is None else _spec_key(spec)
        if key is None:
            _flush()
            run_key = None
            groups.append([entry])
            continue
        if key != run_key:
            _flush()
            run_key = key
        if k <= 1:
            groups.append([entry])
            continue
        run.append(entry)
        if len(run) == k:
            groups.append(list(run))
            run.clear()
    _flush()
    return groups


def estimate_spec_bytes(
    spec,
    *,
    node_cols: float = 16.0,
    edge_cols: float = 8.0,
    graph_cols: float = 12.0,
    triplet_cols: float = 4.0,
) -> int:
    """Coarse host-RAM bound of one collated batch at ``spec``:
    float32-equivalent columns per node, edge, graph and triplet row.
    Used only to cap an auto-picked K against ``max_host_bytes``."""
    triplets = spec.num_triplets or 0
    return int(
        4
        * (
            spec.num_nodes * node_cols
            + spec.num_edges * edge_cols
            + spec.num_graphs * graph_cols
            + triplets * triplet_cols
        )
    )


def auto_superstep_k(
    plan,
    *,
    max_host_bytes: int = 256 << 20,
    candidates: Sequence[int] = (32, 16, 8),
    min_grouped_frac: float = 0.5,
    min_steps: int = 64,
) -> int:
    """The ``superstep: {steps: "auto"}`` decision, a pure function of
    one epoch's plan: the largest candidate K whose full K-groups cover
    at least ``min_grouped_frac`` of the epoch's steps and whose K
    batches stay under ``max_host_bytes`` (``estimate_spec_bytes`` x K).
    Plans shorter than ``min_steps`` return 1."""
    plan = list(plan)
    if len(plan) < max(int(min_steps), 2):
        return 1
    specs = [s for _, s in plan if s is not None]
    if not specs:
        return 1
    biggest = max(estimate_spec_bytes(s) for s in specs)
    for k in sorted({int(c) for c in candidates}, reverse=True):
        if k <= 1:
            continue
        if biggest * k > int(max_host_bytes):
            continue
        grouped = sum(
            len(g) for g in superstep_groups(plan, k) if len(g) > 1
        )
        if grouped >= min_grouped_frac * len(plan):
            return k
    return 1
