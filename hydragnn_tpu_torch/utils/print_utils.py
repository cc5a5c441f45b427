"""Verbosity-gated printing and the per-run log file.

Counterpart of ``hydragnn_tpu/utils/print_utils.py``: prints gated by a
0-4 verbosity level (``print_distributed``), the run's log file tee
(``setup_log``) and its log name (``get_log_name_config``). Under
several ranks only rank 0 prints and keeps the log file; the other
helpers (``print_master``, ``log``, ``iterate_tqdm``) have no caller
yet.
"""

from __future__ import annotations

import os
from typing import Optional, TextIO

from hydragnn_tpu_torch.parallel.runtime import rank

_LOG_FILE: Optional[TextIO] = None


def print_distributed(verbosity: int, verbosity_threshold: int, *args) -> None:
    """Print (and tee to the log file) when verbosity >= threshold, on
    rank 0."""
    if verbosity >= verbosity_threshold and rank() == 0:
        print(*args, flush=True)
        if _LOG_FILE is not None:
            print(*args, file=_LOG_FILE, flush=True)


def setup_log(log_name: str, path: str = "./logs/") -> str:
    """Open (append) the run's log file, closing an earlier one (rank 0's
    ``log.0.txt``; the other ranks print nothing)."""
    global _LOG_FILE
    run_dir = os.path.join(path, log_name)
    os.makedirs(run_dir, exist_ok=True)
    fname = os.path.join(run_dir, "log.0.txt")
    if rank() != 0:
        return fname
    if _LOG_FILE is not None:
        _LOG_FILE.close()
    _LOG_FILE = open(fname, "a")
    return fname


def get_log_name_config(config: dict) -> str:
    """The run/log name derived from the config."""
    arch = config["NeuralNetwork"]["Architecture"]
    training = config["NeuralNetwork"]["Training"]
    name = config.get("Dataset", {}).get("name", "run")
    return (
        f"{name}_{arch.get('mpnn_type','model')}"
        f"_hd{arch.get('hidden_dim')}"
        f"_l{arch.get('num_conv_layers')}"
        f"_e{training.get('num_epoch')}"
    )
