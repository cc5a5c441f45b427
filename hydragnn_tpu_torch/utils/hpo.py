"""Hyperparameter-optimization helpers.

Counterpart of ``hydragnn_tpu/utils/hpo.py``: a trial runner that
applies a flat ``{dotted.key: value}`` dict onto the JSON config and
calls the port's ``run_training`` (on ``device``, the card by default),
a built-in random search that draws the JAX package's trial sequence
from the same seed and space, and an objective for
``optuna.create_study`` where Optuna is installed.

Trials run one after another in the calling process. Each is a fresh
``run_training``: its graph cache, graph pool and checkpoint writer
thread belong to its returned state, which ``run_trial`` drops before
the next trial starts.
"""

from __future__ import annotations

import copy
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def set_config_value(config: dict, dotted_key: str, value) -> None:
    """Assign ``NeuralNetwork.Architecture.hidden_dim``-style keys."""
    parts = dotted_key.split(".")
    node = config
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def apply_trial(config: dict, params: Dict[str, Any]) -> dict:
    """New config with the trial's dotted-key parameters applied."""
    out = copy.deepcopy(config)
    for k, v in params.items():
        set_config_value(out, k, v)
    return out


def run_trial(config: dict, params: Dict[str, Any], datasets=None, *, device=None) -> float:
    """Train with the trial parameters; objective = best val loss."""
    from hydragnn_tpu_torch.runner import run_training

    trial_config = apply_trial(config, params)
    _, _, _, hist, _ = run_training(trial_config, datasets=datasets, device=device)
    # The trial's state (its graph cache and pool) is unreachable now:
    # free what reference cycles still hold before the next trial captures.
    gc.collect()
    return float(min(hist.val_loss)) if hist.val_loss else float("inf")


def _sample(space: Dict[str, Sequence], rng) -> Dict[str, Any]:
    out = {}
    for k, choices in space.items():
        out[k] = choices[int(rng.integers(0, len(choices)))]
    return out


def random_search(
    config: dict,
    space: Dict[str, Sequence],
    n_trials: int = 10,
    *,
    datasets=None,
    seed: int = 0,
    objective: Optional[Callable[[dict, Dict[str, Any]], float]] = None,
    device=None,
) -> Tuple[Dict[str, Any], float, List[Tuple[Dict[str, Any], float]]]:
    """Random search over a {dotted_key: choices} space: ``n_trials``
    draws, a repeated draw skipped. Returns (best_params, best_value,
    all_trials)."""
    rng = np.random.default_rng(seed)
    fn = objective or (lambda c, p: run_trial(c, p, datasets=datasets, device=device))
    trials: List[Tuple[Dict[str, Any], float]] = []
    best_p: Dict[str, Any] = {}
    best_v = float("inf")
    seen = set()
    for _ in range(n_trials):
        params = _sample(space, rng)
        key = tuple(sorted(params.items()))
        if key in seen:
            continue
        seen.add(key)
        value = fn(config, params)
        trials.append((params, value))
        if value < best_v:
            best_p, best_v = params, value
    return best_p, best_v, trials


def optuna_objective(
    config: dict,
    space: Dict[str, Sequence],
    datasets=None,
    *,
    device=None,
) -> Callable:
    """Objective for ``optuna.create_study(direction="minimize")``:
    every space entry becomes a categorical suggestion."""

    def objective(trial):
        params = {
            k: trial.suggest_categorical(k.replace(".", "__"), list(v))
            for k, v in space.items()
        }
        return run_trial(config, params, datasets=datasets, device=device)

    return objective
