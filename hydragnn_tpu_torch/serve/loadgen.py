"""Synthetic request streams for serving.

Counterpart of the stream half of ``hydragnn_tpu/serve/loadgen.py``
(``_HISTOGRAMS``, ``synthetic_request_samples``), copied so the same
(histogram, seed) gives the same graphs bit for bit. The load-generator
bench and its gates come with the serving benchmark (ROADMAP Queue 1
item 14).
"""

from __future__ import annotations

import zlib
from typing import List

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample

# Size-histogram anchors: (node mean, node std, node lo, node hi,
# edges-per-node). qm9/zinc node statistics follow the public corpus
# descriptions (qm9 <= 29 atoms incl. H; zinc drug-like ~23 heavy
# atoms); edges-per-node ~2.1 matches bond-graph degree after
# symmetrization.
_HISTOGRAMS = {
    "qm9": (18.0, 3.0, 4, 29, 2.1),
    "zinc": (23.0, 4.5, 8, 38, 2.2),
    # Heavy-tailed zinc: the same drug-like body, but a slice of
    # requests are 2-3x giants (macrocycles / fragment dimers). THE
    # mix the fleet router's spec-affinity policy exists for — giants
    # should concentrate on the replica whose big-budget executable
    # stays warm instead of salting every replica's bins.
    "zinc_skew": (23.0, 4.5, 8, 104, 2.2),
}

# Heavy-tail mixture for *_skew histograms: (tail fraction, node-count
# multiplier lo, hi) applied over the body mean.
_SKEW_TAILS = {
    "zinc_skew": (0.12, 2.0, 3.5),
}


def synthetic_request_samples(
    histogram: str = "qm9", n_requests: int = 128, *, seed: int = 0
) -> List[GraphSample]:
    """Deterministic GraphSamples whose size distribution follows the
    named corpus histogram: the request payloads and the offline fitting
    corpus (serving budgets are fitted from sizes alone). ``*_skew``
    histograms mix in a heavy tail of giants (module constants)."""
    if histogram not in _HISTOGRAMS:
        raise ValueError(
            f"unknown histogram {histogram!r}; choose from "
            f"{sorted(_HISTOGRAMS)}"
        )
    mean, std, lo, hi, epn = _HISTOGRAMS[histogram]
    tail = _SKEW_TAILS.get(histogram)
    # crc32, not hash(): str hashing is randomized per process, and
    # the stream must reproduce across invocations.
    rng = np.random.default_rng(
        (seed, zlib.crc32(histogram.encode()) & 0xFFFF)
    )
    out = []
    for _ in range(int(n_requests)):
        if tail is not None and rng.random() < tail[0]:
            n = int(
                np.clip(
                    round(rng.uniform(tail[1], tail[2]) * mean),
                    lo,
                    hi,
                )
            )
        else:
            n = int(np.clip(round(rng.normal(mean, std)), lo, hi))
        e = max(int(round(n * epn + rng.normal(0.0, 2.0))), 1)
        senders = rng.integers(0, n, e)
        receivers = (senders + 1 + rng.integers(0, max(n - 1, 1), e)) % n
        out.append(
            GraphSample(
                x=rng.normal(size=(n, 1)).astype(np.float32),
                pos=rng.uniform(0, 4.0, size=(n, 3)).astype(np.float32),
                edge_index=np.stack([senders, receivers]).astype(np.int64),
                y_graph=np.array([rng.normal()], dtype=np.float32),
            )
        )
    return out
