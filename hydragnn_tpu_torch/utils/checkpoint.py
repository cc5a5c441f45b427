"""Synchronous checkpoints of a training run.

Counterpart of the synchronous part of ``hydragnn_tpu/utils/checkpoint.py``:
``save_checkpoint``, ``load_checkpoint``, ``checkpoint_exists``,
``find_continue_log_name`` and ``checkpoint_settings``. The files keep
the JAX package's layout and semantics:

- a run's files live in ``./logs/<log_name>/``;
- ``checkpoint.pt`` is the latest state, ``checkpoint_epoch<N>.pt`` the
  state saved on epoch ``N`` (written with ``latest`` refreshed to the
  same bytes, then pruned to the newest ``keep``);
- every file is written to ``<path>.tmp`` and moved into place with
  ``os.replace``, so a kill mid-write never leaves a truncated file;
- a load with no epoch reads ``latest`` and, when it is missing or
  cannot be restored, falls back to the newest per-epoch file that can,
  with a warning.

The format is the port's own: one ``torch.save`` of ``{"model":
model.state_dict()`` (parameters and batch-norm running statistics),
``"optimizer": optimizer.state_dict(), "step": n}``, under the ``.pt``
suffix, so the port never reads the JAX package's msgpack files. The
optimizer's state holds its learning rate and step count as device
tensors; a load copies every saved tensor into the live one (the
module's ``load_state_dict`` copies parameters in place, the port's
optimizers do the same for their state), so CUDA graphs captured before
a restore replay with the restored values. The asynchronous writer, the
resume manifest and ``continue`` are ROADMAP Queue 1 item 12.

Under several ranks every rank calls ``save_checkpoint`` together: an
FSDP2-sharded model's parameters and optimizer state are all-gathered
into full tensors (``parallel/runtime.gather_to_host``), so the file is
PR 6's format and ``run_prediction(config)`` restores it in one
process; rank 0 writes, and every rank waits at a barrier until the file
is in place. A restore into sharded tensors copies each rank's shard.
"""

from __future__ import annotations

import glob
import io
import os
import re
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from hydragnn_tpu_torch.parallel.runtime import gather_to_host, rank, world_size

CHECKPOINT_DIR = "./logs"
_LATEST = "checkpoint.pt"
_EPOCH_RE = re.compile(r"checkpoint_epoch(\d+)\.pt$")


def _warn(msg: str) -> None:
    print(f"[checkpoint] {msg}", flush=True)


@dataclass
class CheckpointSettings:
    """The resolved ``Training.Checkpoint`` block: ``true`` means
    save-on-best; the object form's ``enabled`` says the same (its
    durability knobs belong to the asynchronous writer, item 12)."""

    enabled: bool = False


def checkpoint_settings(training: dict) -> CheckpointSettings:
    raw = training.get("Checkpoint", False)
    if isinstance(raw, dict):
        return CheckpointSettings(enabled=bool(raw.get("enabled", True)))
    return CheckpointSettings(enabled=bool(raw))


def _ckpt_path(log_name: str, epoch: Optional[int] = None, *, make: bool = True) -> str:
    d = os.path.join(CHECKPOINT_DIR, log_name)
    if make:
        os.makedirs(d, exist_ok=True)
    return os.path.join(d, _LATEST if epoch is None else f"checkpoint_epoch{epoch}.pt")


def _epoch_files_newest_first(log_name: str) -> list:
    files = glob.glob(os.path.join(CHECKPOINT_DIR, log_name, "checkpoint_epoch*.pt"))
    return sorted(files, key=lambda p: int(_EPOCH_RE.search(p).group(1)), reverse=True)


def _prune_old_epochs(log_name: str, keep: int) -> None:
    """Keep the newest ``keep`` per-epoch files (``keep`` <= 0 keeps all)."""
    for p in _epoch_files_newest_first(log_name)[keep:] if keep > 0 else []:
        try:
            os.remove(p)
        except OSError:
            pass


def _atomic_write_bytes(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _full(tree):
    """``tree`` with every tensor whole on the host (module docstring)."""
    if isinstance(tree, torch.Tensor):
        return gather_to_host(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _full(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_full(v) for v in tree)
    return tree


def _barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _state_bytes(state) -> bytes:
    """A ``TrainState``'s checkpoint blob (whole tensors on the host)."""
    buf = io.BytesIO()
    torch.save({"model": _full(state.model.state_dict()),
                "optimizer": _full(state.optimizer.state_dict()),
                "step": int(state.step)}, buf)
    return buf.getvalue()


def save_checkpoint(log_name: str, state, *, epoch: Optional[int] = None,
                    keep: int = 0) -> str:
    """Write ``state`` (a ``TrainState``): the epoch file and ``latest``
    with ``epoch``, else ``latest`` alone; then prune to the newest
    ``keep`` epoch files (0 keeps them all). Returns the path written.
    Every rank calls this; rank 0 writes (module docstring)."""
    blob = _state_bytes(state)
    writer = rank() == 0
    path = _ckpt_path(log_name, epoch, make=writer)
    if writer:
        _atomic_write_bytes(path, blob)
        if epoch is not None:
            _atomic_write_bytes(_ckpt_path(log_name, None), blob)
            _prune_old_epochs(log_name, keep)
    _barrier()
    return path


def _restore(state, path: str) -> None:
    """Load the blob at ``path`` into ``state`` in place, bit for bit:
    each tensor is copied into the live one on its device (module
    docstring)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    live = state.model.state_dict()
    if any(hasattr(t, "full_tensor") for t in live.values()):
        from hydragnn_tpu_torch.train.optimizer import copy_into

        if set(live) != set(blob["model"]):
            raise ValueError("checkpoint holds another model's tensors")
        with torch.no_grad():
            for k, t in live.items():
                copy_into(t, blob["model"][k])
    else:
        state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])


def _try_restore(state, path: str) -> bool:
    """Restore ``path`` into ``state``, or warn and return False when it
    is missing or cannot be read."""
    if not os.path.exists(path):
        return False
    try:
        _restore(state, path)
        return True
    except Exception as e:  # a truncated or foreign file
        _warn(f"checkpoint at {path} is not restorable ({type(e).__name__}: {e}) "
              "— skipping it")
        return False


def load_checkpoint(log_name: str, state, *, epoch: Optional[int] = None):
    """Restore a ``TrainState`` written by ``save_checkpoint`` into
    ``state`` (whose model and optimizer give the structure) and return
    it. With ``epoch`` that file is read and any failure raises; without,
    ``latest``, else the newest restorable epoch file (with a
    warning)."""
    path = _ckpt_path(log_name, epoch, make=False)
    if epoch is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(f"No checkpoint at {path}")
        _restore(state, path)
        return state
    if _try_restore(state, path):
        return state
    for cand in _epoch_files_newest_first(log_name):
        if _try_restore(state, cand):
            _warn(f"falling back to {cand} (latest checkpoint missing or corrupt)")
            return state
    raise FileNotFoundError(f"No restorable checkpoint at {path} (or any epoch file)")


def checkpoint_exists(log_name: str, *, epoch: Optional[int] = None) -> bool:
    return os.path.exists(_ckpt_path(log_name, epoch, make=False))


def _has_artifacts(log_name: str) -> bool:
    return checkpoint_exists(log_name) or bool(_epoch_files_newest_first(log_name))


def find_continue_log_name(log_name: str) -> str:
    """The run directory holding this config's checkpoints. The derived
    name encodes ``num_epoch``, so a config whose ``num_epoch`` changed
    since training points at an empty directory: then the newest sibling
    that differs only in the ``_e<N>`` suffix and has checkpoints, with a
    warning; else ``log_name`` itself. (The JAX package also takes the
    caller's in-flight run name and compares a sibling's stored config
    fingerprint, for ``continue``; both come with item 12.)"""
    if _has_artifacts(log_name):
        return log_name
    m = re.match(r"^(.*_e)\d+$", log_name)
    if not m:
        return log_name
    stem = m.group(1)
    cands = [
        os.path.basename(p)
        for p in glob.glob(os.path.join(CHECKPOINT_DIR, glob.escape(stem) + "*"))
        if re.fullmatch(r"\d+", os.path.basename(p)[len(stem):])
        and _has_artifacts(os.path.basename(p))
    ]
    if not cands:
        return log_name
    cand = max(cands, key=lambda n: os.path.getmtime(os.path.join(CHECKPOINT_DIR, n)))
    _warn(f"no checkpoint under '{log_name}' — using '{cand}' (same run name up to "
          "num_epoch)")
    return cand
