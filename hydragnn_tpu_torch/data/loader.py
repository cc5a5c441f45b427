"""Host-side batching: shuffled, bucket-padded epochs and dataset splits.

Counterpart of ``hydragnn_tpu/data/loader.py``: ``GraphLoader`` on its
serial path (an epoch's batch order from ``epoch_batch_indices``, each
batch padded to one worst-case shape or up the bucket ladder, collated
on the host) and ``split_dataset``. Batch order, pad specs and collated
arrays equal the JAX package's for the same seed.

The port's batches carry the block plan at the Hopper tiles by default
(``with_segment_plan=True``), so every CFConv layer runs K1 forward and
K2 backward; ``with_segment_plan=False`` gives the ``index_add_``
scatter path. There is no crossover table. Bin packing, spec schedules,
resampling, triplets, the parallel input pipeline and supersteps come
with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphBatch, GraphSample, PadSpec, collate
from hydragnn_tpu_torch.data.padschedule import (
    dataset_size_arrays,
    epoch_batch_indices,
    ladder_spec,
    worst_case_spec_from_sizes,
)

# Distinct ladder shapes "auto" padding accepts (the JAX package's
# HYDRAGNN_TPU_MAX_PAD_BUCKETS default).
MAX_PAD_BUCKETS = 6


class GraphLoader:
    """Iterates GraphBatches (CPU tensors) over a list of GraphSamples.

    ``fixed_pad=True`` pads every batch to the dataset's worst-case
    shape; ``False`` pads each batch up the bucket ladder; ``"auto"``
    takes the ladder when the first four epochs' orders give at most
    ``MAX_PAD_BUCKETS`` distinct shapes, and clamps to the worst case
    for good once twice that many are seen. ``cache_batches`` keeps a
    fixed-order loader's collated batches for later epochs."""

    def __init__(
        self,
        dataset: Sequence[GraphSample],
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        fixed_pad: "bool | str" = True,
        with_segment_plan: bool = True,
        cache_batches: bool = False,
    ):
        self.dataset = list(dataset)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.with_segment_plan = bool(with_segment_plan)
        self._seed = int(seed)
        self._epoch = 0
        self._auto_selected = False
        self._seen_specs: set = set()
        if fixed_pad == "auto":
            fixed_pad = (
                True if not len(self.dataset) else not self._ladder_is_small()
            )
            self._auto_selected = not fixed_pad
        self.fixed_pad = fixed_pad
        self.cache_batches = cache_batches and not shuffle
        self._batch_cache: Optional[List[GraphBatch]] = None
        self.pad_spec: Optional[PadSpec] = None
        if fixed_pad and len(self.dataset):
            self.pad_spec = self._worst_case_spec()

    def _size_arrays(self) -> tuple:
        return dataset_size_arrays(self.dataset)

    def _epoch_batches(self, epoch: int) -> Iterator[np.ndarray]:
        return epoch_batch_indices(
            len(self.dataset), self.batch_size, shuffle=self.shuffle,
            seed=self._seed, epoch=epoch,
        )

    def planned_spec_keys(self, epochs: int = 2) -> set:
        """Distinct bucketed (nodes, edges, graphs) keys of the first
        ``epochs`` epochs on the ladder."""
        nodes, edges = self._size_arrays()
        keys = set()
        for ep in range(epochs):
            for idx in self._epoch_batches(ep):
                spec = ladder_spec(int(nodes[idx].sum()), int(edges[idx].sum()), len(idx))
                keys.add((spec.num_nodes, spec.num_edges, spec.num_graphs))
        return keys

    def _ladder_is_small(self) -> bool:
        return len(self.planned_spec_keys(epochs=4)) <= MAX_PAD_BUCKETS

    def _worst_case_spec(self) -> PadSpec:
        nodes, edges = self._size_arrays()
        return worst_case_spec_from_sizes(nodes, edges, self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _fixed_batch_spec(self) -> PadSpec:
        return PadSpec(
            num_nodes=self.pad_spec.num_nodes,
            num_edges=self.pad_spec.num_edges,
            num_graphs=self.batch_size + 1,
        )

    def epoch_plan(self, epoch: int) -> Iterator[tuple]:
        """``(idx, spec)`` for every batch of one epoch, from size
        metadata alone."""
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

    def __iter__(self) -> Iterator[GraphBatch]:
        if self._batch_cache is not None:
            yield from self._batch_cache
            return
        cache: Optional[List[GraphBatch]] = [] if self.cache_batches else None
        for idx, spec in self.epoch_plan(self._epoch):
            batch = collate(
                [self.dataset[i] for i in idx], spec,
                with_segment_plan=self.with_segment_plan,
            )
            if cache is not None:
                cache.append(batch)
            yield batch
        if cache is not None:
            self._batch_cache = cache


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
