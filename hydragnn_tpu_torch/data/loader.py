"""Host-side batching: shuffled, bucket-padded or bin-packed epochs, the
serial superstep feed, and dataset splits.

Counterpart of ``hydragnn_tpu/data/loader.py``: ``GraphLoader`` on its
serial path (an epoch's batch order from ``epoch_batch_indices``, each
batch padded to one worst-case shape or up the bucket ladder, or the
epoch's order first-fit-decreasing packed into fitted budgets, collated
on the host), ``SuperstepLoader`` (the epoch plan delivered as groups of
K same-spec batches, ``MacroBatch``, and singletons) and
``split_dataset``. Batch order, pad specs, packed bins, superstep groups
and collated arrays equal the JAX package's for the same seed.

A loader keeps a container dataset lazy (``BinDataset``,
``SimplePickleDataset``, ``StoreDataset``: its samples are read per
batch, its sizes from its header where it has one) and zero-fills one
dataset-wide optional-field map in every batch (``ensure_fields``;
``graph.optional_field_widths``), as the JAX package's loader does.

The port's batches carry the block plan at the Hopper tiles by default
(``with_segment_plan=True``), packed bins included, so every aggregation
runs K1 forward and K2 backward; ``with_segment_plan=False`` gives the
``index_add_`` scatter path. There is no crossover table.
``with_triplets`` (DimeNet) attaches the angular triplets; as in the JAX
package it refuses packing (budgets do not count triplets), and
``fixed_pad="auto"`` then keeps the one worst-case shape, whose triplet
count is the bucketed sum of the ``batch_size`` largest samples' counts;
on the ladder (``fixed_pad=False``) each batch's spec is derived from
its own samples at collate time (a ``None`` plan entry). Under the dp
and multibranch schemes a loader takes a shared ``spec_schedule``
(``padschedule.dp_spec_schedule``/``slot_spec_schedule``: every rank's
batch of a step padded to the step's one spec) or packs
device-coordinated (``pack_dp_shards``: ``padschedule.pack_epoch_ffd_dp``),
as in the JAX package. ``num_samples`` resamples each epoch (with
replacement past the dataset's size) and ``drop_last`` drops a short
last batch, as in the JAX package: constructor arguments only, which no
config key reaches. The parallel feed over a loader's
epoch plan (collation workers, packed assembly) is
``data/pipeline.ParallelPipelineLoader``; the prefetch thread is
``data/prefetch.PrefetchLoader``.

Mid-epoch resume: ``skip_to(step)`` on a loader (and on
``SuperstepLoader`` and ``parallel/dp.DPLoader``) makes its next
iteration start at optimizer step ``step`` of the current epoch,
replaying the deterministic epoch plan without collating the consumed
entries; ``set_epoch`` drops an unused cursor. A partial epoch never
fills a replay cache.

Where the JAX package stacks a superstep group into one ``[K, ...]``
host batch, the port keeps its K collated batches side by side
(``MacroBatch``): on the card the step cache packs them into one pinned
buffer and one copy (``train/capture.py``), on the CPU the loop runs
them one by one.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import (
    GraphBatch,
    GraphSample,
    PadSpec,
    bucket_size,
    collate,
    count_triplets,
    optional_field_widths,
)
from hydragnn_tpu_torch.data.padschedule import (
    MAX_PAD_BUCKETS,
    PadSpecSchedule,
    batch_size_rows,
    dataset_size_arrays,
    epoch_batch_indices,
    fit_pack_budgets,
    ladder_spec,
    ladder_spec_keys,
    pack_epoch_ffd,
    pack_epoch_ffd_dp,
    superstep_groups,
    worst_case_spec_from_sizes,
)


class GraphLoader:
    """Iterates GraphBatches (CPU tensors) over a dataset of GraphSamples.

    A container with ``__len__`` and ``__getitem__`` (``BinDataset``,
    ``SimplePickleDataset``, ``StoreDataset``) is kept as it is and read
    sample by sample per batch; its sizes come from ``sample_sizes()``
    where it has one (``padschedule.dataset_size_arrays``), so building
    the loader reads no sample. Lists and tuples are copied; anything
    else (a generator) is materialized.

    ``fixed_pad=True`` pads every batch to the dataset's worst-case
    shape; ``False`` pads each batch up the bucket ladder; ``"auto"``
    takes the ladder when the first four epochs' orders give at most
    ``MAX_PAD_BUCKETS`` distinct shapes, and clamps to the worst case
    for good once twice that many are seen. ``cache_batches`` keeps a
    fixed-order loader's collated batches for later epochs.

    ``packing`` replaces fixed-size batches with bin-packed ones: each
    epoch's order is first-fit-decreasing packed into ``pack_budgets``
    (or budgets fitted from this loader's own size histogram with
    ``pack_max_budgets``, ``pack_slack`` and ``pack_max_graphs``), one
    batch per bin, padded to its budget's shape; ``pack_dp_shards`` > 1
    packs device-coordinated for that many data slots. ``spec_schedule``
    pads batch j of epoch e to ``spec_schedule.spec(e, j)``.
    ``with_triplets`` attaches angular triplets (module docstring) and
    can neither pack nor follow a schedule.

    ``num_samples`` draws that many samples each epoch (the reference's
    oversampling sampler; with replacement past the dataset's size); it
    needs ``shuffle``, is never cached, and refuses ``pack_dp_shards`` >
    1 (a resampled epoch could not be proven coordinatable up front).

    ``ensure_fields`` (default: ``graph.optional_field_widths`` over the
    dataset) names the optional fields every batch carries, zero-filled
    where a batch's samples lack them, so a mixed dataset gives batches
    of one structure; callers holding several loaders pass one map over
    all their datasets."""

    def __init__(
        self,
        dataset: Sequence[GraphSample],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        fixed_pad: "bool | str" = True,
        drop_last: bool = False,
        num_samples: Optional[int] = None,
        with_triplets: bool = False,
        with_segment_plan: bool = True,
        cache_batches: bool = False,
        packing: bool = False,
        pack_budgets: Optional[List] = None,
        pack_max_budgets: int = 2,
        pack_slack: Optional[float] = None,
        pack_max_graphs: Optional[int] = None,
        pack_dp_shards: int = 0,
        spec_schedule: Optional[PadSpecSchedule] = None,
        ensure_fields: Optional[dict] = None,
    ):
        if isinstance(dataset, (list, tuple)) or not (
            hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__")
        ):
            dataset = list(dataset)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.num_samples = None if num_samples is None else int(num_samples)
        if self.num_samples is not None and not shuffle:
            raise ValueError(
                "num_samples (oversampling) draws a random sample each epoch; pass shuffle=True"
            )
        self.drop_last = bool(drop_last)
        self.with_triplets = bool(with_triplets)
        self.with_segment_plan = bool(with_segment_plan)
        self._seed = int(seed)
        self._epoch = 0
        self._auto_selected = False
        self._seen_specs: set = set()
        self.spec_schedule = spec_schedule
        if spec_schedule is not None:
            if self.with_triplets:
                raise ValueError(
                    "spec_schedule does not cover triplet counts; use fixed "
                    "padding for triplet-bearing models"
                )
            fixed_pad = False
        self.packing = bool(packing)
        self.pack_dp_shards = max(int(pack_dp_shards), 0)
        if self.pack_dp_shards > 1 and self.num_samples is not None:
            raise ValueError(
                "device-coordinated packing (pack_dp_shards) is incompatible with "
                "num_samples resampling: a resampled epoch can become infeasible to "
                "coordinate mid-train"
            )
        self.pack_budgets: Optional[List] = None
        self._pack_plan_cache: Optional[tuple] = None
        if self.packing:
            if spec_schedule is not None:
                raise ValueError(
                    "packing is incompatible with a shared spec_schedule (a packed "
                    "dp run coordinates shapes through pack_dp_shards)"
                )
            if self.with_triplets:
                raise ValueError(
                    "packing budgets do not cover triplet counts; use "
                    "fixed padding for triplet-bearing models"
                )
            fixed_pad = False
            if pack_budgets is not None:
                self.pack_budgets = list(pack_budgets)
            elif len(self.dataset):
                self.pack_budgets = fit_pack_budgets(
                    *self._size_arrays(), self.batch_size,
                    max_budgets=pack_max_budgets, slack=pack_slack,
                    max_graphs=pack_max_graphs, seed=self._seed,
                )
        if fixed_pad == "auto":
            # Triplet counts need each sample's edges: keep the one
            # worst-case shape there.
            fixed_pad = (
                True if (self.with_triplets or not len(self.dataset))
                else not self._ladder_is_small()
            )
            self._auto_selected = not fixed_pad
        self.fixed_pad = fixed_pad
        self.cache_batches = cache_batches and not shuffle and self.num_samples is None
        self._batch_cache: Optional[List[GraphBatch]] = None
        self._skip_next = 0
        self.pad_spec: Optional[PadSpec] = None
        self._ensure_fields = (
            ensure_fields if ensure_fields is not None
            else optional_field_widths(self.dataset) if len(self.dataset) else {}
        )
        if fixed_pad and len(self.dataset):
            self.pad_spec = self._worst_case_spec()

    def _size_arrays(self) -> tuple:
        return dataset_size_arrays(self.dataset)

    def _epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        return epoch_batch_indices(
            len(self.dataset), self.batch_size, shuffle=self.shuffle,
            seed=self._seed, epoch=epoch, num_samples=self.num_samples,
            drop_last=self.drop_last,
        )

    def _packed_plan(self, epoch: int) -> List[tuple]:
        """One epoch's packed ``(idx, PackSpec)`` bins, cached per epoch;
        a fixed-order loader packs once for every epoch."""
        if not self.shuffle:
            epoch = 0
        if self._pack_plan_cache is not None and self._pack_plan_cache[0] == epoch:
            return self._pack_plan_cache[1]
        if not self.pack_budgets:
            return []
        nodes, edges = self._size_arrays()
        batches = list(self._epoch_batches(epoch))
        order = np.concatenate(batches) if batches else np.zeros(0, np.int64)
        if self.pack_dp_shards > 1:
            bins = pack_epoch_ffd_dp(order, nodes, edges, self.pack_budgets,
                                     self.pack_dp_shards)
        else:
            bins = pack_epoch_ffd(order, nodes, edges, self.pack_budgets)
        self._pack_plan_cache = (epoch, bins)
        return bins

    def packing_stats(self, epoch: Optional[int] = None) -> Optional[dict]:
        """One epoch's packed plan in numbers (None when packing is
        off): bins, budgets, node and edge fill, and the executed/real
        (nodes + edges) pad ratio."""
        if not self.packing or not self.pack_budgets:
            return None
        plan = self._packed_plan(self._epoch if epoch is None else epoch)
        if not plan:
            return None
        nodes, edges = self._size_arrays()
        real_n = sum(int(nodes[idx].sum()) for idx, _ in plan)
        real_e = sum(int(edges[idx].sum()) for idx, _ in plan)
        exe_n = sum(spec.num_nodes for _, spec in plan)
        exe_e = sum(spec.num_edges for _, spec in plan)
        return {
            "batches": len(plan),
            "budgets": len(self.pack_budgets),
            "node_fill": real_n / max(exe_n, 1),
            "edge_fill": real_e / max(exe_e, 1),
            "pad_ratio": (exe_n + exe_e) / max(real_n + real_e, 1),
        }

    def epoch_size_rows(self, epoch: int) -> np.ndarray:
        """``[n_batches, 3]`` size rows of one epoch's batches
        (``padschedule.batch_size_rows``): the loader's side of the spec
        schedules."""
        nodes, edges = self._size_arrays()
        if self.packing:
            return batch_size_rows(nodes, edges, (idx for idx, _ in self._packed_plan(epoch)))
        return batch_size_rows(nodes, edges, self._epoch_batches(epoch))

    def planned_spec_keys(self, epochs: int = 2) -> set:
        """Distinct (nodes, edges, graphs) keys of the first ``epochs``
        epochs: the budgets when packing, else the ladder's."""
        if self.packing:
            return {
                (b.num_nodes, b.num_edges, b.num_graphs)
                for b in (self.pack_budgets or [])
            }
        return ladder_spec_keys(
            *self._size_arrays(), self.batch_size, shuffle=self.shuffle,
            seed=self._seed, epochs=epochs, num_samples=self.num_samples,
            drop_last=self.drop_last,
        )

    def _ladder_is_small(self) -> bool:
        return len(self.planned_spec_keys(epochs=4)) <= MAX_PAD_BUCKETS

    def _worst_case_spec(self) -> PadSpec:
        nodes, edges = self._size_arrays()
        spec = worst_case_spec_from_sizes(nodes, edges, self.batch_size)
        if not self.with_triplets:
            return spec
        t_sizes = sorted((count_triplets(s) for s in self.dataset), reverse=True)
        t = bucket_size(max(sum(t_sizes[: self.batch_size]), 1))
        return PadSpec(num_nodes=spec.num_nodes, num_edges=spec.num_edges,
                       num_graphs=spec.num_graphs, num_triplets=t)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._skip_next = 0  # a cursor never outlives its epoch

    def skip_to(self, step: int) -> None:
        """The next iteration starts at plan entry ``step`` of the
        current epoch; the consumed entries are planned (so the ladder's
        bookkeeping runs as in a whole epoch) but not collated."""
        self._skip_next = max(0, int(step))

    def __len__(self) -> int:
        if self.packing:
            return len(self._packed_plan(self._epoch))
        n = len(self.dataset) if self.num_samples is None else self.num_samples
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fixed_batch_spec(self) -> PadSpec:
        return PadSpec(
            num_nodes=self.pad_spec.num_nodes,
            num_edges=self.pad_spec.num_edges,
            num_graphs=self.batch_size + 1,
            num_triplets=self.pad_spec.num_triplets,
        )

    def epoch_plan(self, epoch: int) -> Iterator[tuple]:
        """``(idx, spec)`` for every batch of one epoch, from size
        metadata alone: the packed bins when packing. On the ladder with
        triplets the spec is ``None``: each batch's own (its triplet
        count needs its edges) is derived at collate time."""
        if self.packing:
            for idx, budget in self._packed_plan(epoch):
                yield idx, budget.pad_spec()
            return
        if self.spec_schedule is not None:
            nodes, edges = self._size_arrays()
            for j, idx in enumerate(self._epoch_batches(epoch)):
                spec = self.spec_schedule.spec(epoch, j)
                need = (int(nodes[idx].sum()) + 1, int(edges[idx].sum()), len(idx) + 1)
                if (need[0] > spec.num_nodes or need[1] > spec.num_edges
                        or need[2] > spec.num_graphs):
                    raise ValueError(
                        f"spec schedule out of sync with loader: batch {j} of epoch "
                        f"{epoch} needs {need} but the schedule allows "
                        f"({spec.num_nodes}, {spec.num_edges}, {spec.num_graphs})"
                    )
                yield idx, spec
            return
        if self.pad_spec is None and self.with_triplets:
            yield from ((idx, None) for idx in self._epoch_batches(epoch))
            return
        nodes = edges = None
        for idx in self._epoch_batches(epoch):
            if self.pad_spec is not None:
                yield idx, self._fixed_batch_spec()
                continue
            if nodes is None:
                nodes, edges = self._size_arrays()
            spec = ladder_spec(int(nodes[idx].sum()), int(edges[idx].sum()), len(idx))
            if self._auto_selected:
                # Later reshuffles can reach shapes the simulation did not;
                # past twice the limit, clamp to the worst case for good.
                self._seen_specs.add((spec.num_nodes, spec.num_edges, spec.num_graphs))
                if len(self._seen_specs) > 2 * MAX_PAD_BUCKETS:
                    self.pad_spec = self._worst_case_spec()
                    self._auto_selected = False
                    spec = self._fixed_batch_spec()
            yield idx, spec

    def collate_entry(self, idx, spec) -> GraphBatch:
        """One plan entry's batch (CPU tensors)."""
        samples = [self.dataset[i] for i in idx]
        if spec is None:
            spec = PadSpec.for_samples(samples, with_triplets=self.with_triplets)
        return collate(samples, spec, with_segment_plan=self.with_segment_plan,
                       ensure_fields=self._ensure_fields)

    def __iter__(self) -> Iterator[GraphBatch]:
        skip, self._skip_next = self._skip_next, 0
        if self._batch_cache is not None:
            yield from self._batch_cache[skip:]
            return
        cache: Optional[List[GraphBatch]] = [] if self.cache_batches and not skip else None
        for idx, spec in itertools.islice(self.epoch_plan(self._epoch), skip, None):
            batch = self.collate_entry(idx, spec)
            if cache is not None:
                cache.append(batch)
            yield batch
        if cache is not None:
            self._batch_cache = cache


@dataclass
class MacroBatch:
    """One superstep group: ``k`` consecutive same-spec batches of the
    epoch plan, run as one K-step dispatch."""

    batches: List[GraphBatch]

    @property
    def k(self) -> int:
        return len(self.batches)


class SuperstepLoader:
    """Serial superstep delivery over a GraphLoader: the epoch plan is
    folded into same-spec runs of ``k`` (``padschedule.superstep_groups``)
    and each full run is delivered as one ``MacroBatch``; a run's tail
    (< k entries) as plain batches. Batch content and order equal
    iterating the wrapped loader; only the grouping changes. ``k`` must
    be at least 2 (keep the plain loader for K = 1). A fixed-order
    loader with ``cache_batches`` replays its first epoch's deliveries."""

    def __init__(self, loader: GraphLoader, k: int):
        if int(k) <= 1:
            raise ValueError(
                "SuperstepLoader needs k >= 2; keep the plain loader for K=1"
            )
        self.loader = loader
        self.k = int(k)
        self._cache: Optional[list] = None
        self._skip_next = 0

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)
        self._skip_next = 0

    def skip_to(self, step: int) -> None:
        """The next iteration drops the groups a cursor of ``step``
        optimizer steps covers, the groups cut from the whole epoch plan,
        so the rest are the uninterrupted run's deliveries
        (``drop_consumed_groups``)."""
        self._skip_next = max(0, int(step))

    def __len__(self) -> int:
        """Deliveries (dispatches) this epoch: groups, not steps."""
        return len(superstep_groups(self.loader.epoch_plan(self.loader._epoch), self.k))

    def __iter__(self):
        skip, self._skip_next = self._skip_next, 0
        if self._cache is not None:
            yield from skip_delivered_items(self._cache, skip)
            return
        cache: Optional[list] = [] if self.loader.cache_batches and not skip else None
        plan = list(self.loader.epoch_plan(self.loader._epoch))
        for group in drop_consumed_groups(superstep_groups(plan, self.k), skip):
            batches = [self.loader.collate_entry(idx, spec) for idx, spec in group]
            item = MacroBatch(batches) if len(batches) > 1 else batches[0]
            if cache is not None:
                cache.append(item)
            yield item
        if cache is not None:
            self._cache = cache


def drop_consumed_groups(groups: list, skip_steps: int) -> list:
    """The groups left after a cursor of ``skip_steps`` steps: whole
    groups it covers are dropped. A cursor inside a group (the grouping
    changed between the save and the resume) delivers the group's rest
    as single steps, with a message: no step is run twice or dropped."""
    if skip_steps <= 0:
        return list(groups)
    out, remaining = [], skip_steps
    for g in groups:
        if remaining >= len(g):
            remaining -= len(g)
        elif remaining > 0:
            print("[resume] step cursor lands inside a superstep group "
                  f"(group of {len(g)}, {remaining} consumed) — delivering the "
                  "remainder as per-step batches", flush=True)
            out.extend([e] for e in g[remaining:])
            remaining = 0
        else:
            out.append(g)
    return out


def skip_delivered_items(items: list, skip_steps: int):
    """Deliveries (``MacroBatch`` of k steps, or a batch) after a cursor
    of ``skip_steps`` steps, over a replay cache; a cursor inside an item
    skips the whole item, with a message."""
    remaining = skip_steps
    for item in items:
        k = item.k if isinstance(item, MacroBatch) else 1
        if remaining >= k:
            remaining -= k
            continue
        if remaining > 0:
            print("[resume] step cursor lands inside a cached superstep delivery "
                  f"(k={k}, {remaining} consumed) — skipping the whole item", flush=True)
            remaining = 0
            continue
        yield item


def feed_supports_skip(loader) -> bool:
    """Whether a feed can fast-forward to a mid-epoch cursor: a wrapper
    marked ``_skip_to_delegates`` hands ``skip_to`` to its ``.loader``,
    so the probe asks the loader at the end of such a chain."""
    while getattr(loader, "_skip_to_delegates", False):
        loader = loader.loader
    return hasattr(loader, "skip_to")


def split_dataset(
    dataset: Sequence[GraphSample],
    perc_train: float,
    *,
    stratified: bool = False,
    seed: int = 0,
) -> tuple:
    """train/val/test split; val and test each get (1 - perc_train) / 2.
    ``stratified`` groups samples by composition (the sorted unique
    values of node feature 0) and splits each group proportionally;
    singleton groups go to every split."""
    rng = np.random.default_rng(seed)
    if stratified:
        keys: dict = {}
        for i, s in enumerate(dataset):
            key = tuple(np.unique(np.round(s.x[:, 0], 6)))
            keys.setdefault(key, []).append(i)
        tr_idx: List[int] = []
        va_idx: List[int] = []
        te_idx: List[int] = []
        for _, idxs in sorted(keys.items()):
            idxs = list(idxs)
            rng.shuffle(idxs)
            if len(idxs) == 1:
                tr_idx += idxs
                va_idx += idxs
                te_idx += idxs
                continue
            k = len(idxs)
            n_tr = max(int(round(k * perc_train)), 1)
            n_va = max(int(round(k * (1.0 - perc_train) / 2.0)), 1)
            n_tr = min(n_tr, k - 1)
            tr_idx += idxs[:n_tr]
            va_idx += idxs[n_tr : n_tr + n_va]
            te_idx += idxs[n_tr + n_va :] or idxs[n_tr : n_tr + 1]
        for part in (tr_idx, va_idx, te_idx):
            rng.shuffle(part)
        return (
            [dataset[i] for i in tr_idx],
            [dataset[i] for i in va_idx],
            [dataset[i] for i in te_idx],
        )
    order = np.arange(len(dataset))
    rng.shuffle(order)
    n = len(order)
    n_train = int(n * perc_train)
    n_val = int(n * (1.0 - perc_train) / 2.0)
    return (
        [dataset[i] for i in order[:n_train]],
        [dataset[i] for i in order[n_train : n_train + n_val]],
        [dataset[i] for i in order[n_train + n_val :]],
    )
