"""Serving admission gate: a model snapshot is never served unverified.

Counterpart of ``hydragnn_tpu/serve/admission.py``, with its own copy of
``nonfinite_leaves`` (``hydragnn_tpu/utils/checkpoint.py``) over a
``state_dict``: every floating tensor must be finite, or the engine
refuses to warm, naming the offending tensors.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

import torch


class AdmissionError(RuntimeError):
    """A snapshot failed the serving admission gate (non-finite
    weights)."""


def nonfinite_leaves(state: Mapping[str, torch.Tensor]) -> List[Tuple[str, int, int]]:
    """``[(name, bad_count, size), ...]`` for every floating tensor of
    ``state`` that holds NaN or Inf."""
    out = []
    for name, t in state.items():
        if not (isinstance(t, torch.Tensor) and t.is_floating_point()):
            continue
        bad = int(t.numel() - torch.isfinite(t).sum().item())
        if bad:
            out.append((name, bad, int(t.numel())))
    return out


def admit_state(state: Mapping[str, torch.Tensor], *, source: str = "snapshot") -> dict:
    """Gate a ``state_dict`` for serving. Returns ``{"leaves": n}`` on
    admission; raises ``AdmissionError`` listing the non-finite tensors
    otherwise. Runs at snapshot load, never on the request path."""
    bad = nonfinite_leaves(state)
    if bad:
        detail = ", ".join(
            f"{name} ({n_bad}/{size} non-finite)" for name, n_bad, size in bad[:8]
        )
        more = len(bad) - min(len(bad), 8)
        raise AdmissionError(
            f"REFUSING to serve {source}: {len(bad)} tensor(s) contain "
            f"NaN/Inf — {detail}"
            + (f" (+{more} more)" if more > 0 else "")
            + ". A diverged or corrupted checkpoint must never reach "
            "traffic; recover the last good snapshot or retrain."
        )
    return {"leaves": len(state)}
