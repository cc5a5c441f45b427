"""Stratified subsampling by element composition.

Counterpart of ``hydragnn_tpu/data/sampling.py`` (the reference's
hydragnn/preprocess/stratified_sampling.py:7-48), copied so the kept
samples equal the JAX package's: draw a fraction of a dataset while
keeping the distribution of element compositions (rare compositions
stay represented).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample


def composition_key(sample: GraphSample) -> tuple:
    """Sorted unique first-column node feature values (the species
    signature used by compositional splitting, loader.py split)."""
    return tuple(np.unique(np.round(np.asarray(sample.x)[:, 0], 6)))


def stratified_sample(
    dataset: Sequence[GraphSample],
    perc: float,
    *,
    seed: int = 0,
    verbosity: int = 0,
) -> List[GraphSample]:
    """Keep ~perc of the dataset, proportionally per composition
    category (>= 1 sample per non-empty category)."""
    if not 0.0 < perc <= 1.0:
        raise ValueError(f"perc must be in (0, 1], got {perc}")
    rng = np.random.default_rng(seed)
    groups: dict = {}
    for i, s in enumerate(dataset):
        groups.setdefault(composition_key(s), []).append(i)
    keep: List[int] = []
    for _, idxs in sorted(groups.items()):
        idxs = list(idxs)
        rng.shuffle(idxs)
        k = max(1, int(round(len(idxs) * perc)))
        keep += idxs[:k]
    rng.shuffle(keep)
    if verbosity > 0:
        print(
            f"stratified_sample: kept {len(keep)}/{len(dataset)} over "
            f"{len(groups)} composition categories"
        )
    return [dataset[i] for i in keep]
