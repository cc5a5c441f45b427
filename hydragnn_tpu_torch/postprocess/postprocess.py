"""Output denormalization.

Counterpart of ``hydragnn_tpu/postprocess/postprocess.py``: undo the
dataset-wide minmax scaling applied during raw-data processing so
predictions and targets return to physical units. Host arrays in and
out (``run_prediction`` returns numpy).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def output_denormalize(
    y_minmax: Sequence[Sequence[float]],
    true_values: List[np.ndarray],
    predicted_values: List[np.ndarray],
):
    """Per-head inverse of minmax scaling: v * (max - min) + min.

    ``y_minmax[h]`` = (min, max) of head h's raw target over the
    dataset. A head whose range is 0 keeps a scale of 1.
    Returns (true, predicted) denormalized copies.
    """
    trues, preds = [], []
    for h, (lo, hi) in enumerate(y_minmax):
        scale = float(hi) - float(lo)
        if scale == 0.0:
            scale = 1.0
        trues.append(np.asarray(true_values[h]) * scale + float(lo))
        preds.append(np.asarray(predicted_values[h]) * scale + float(lo))
    return trues, preds
