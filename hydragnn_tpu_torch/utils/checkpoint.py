"""Checkpoints of a training run: synchronous saves, the asynchronous
writer, the resume manifest, and the sharded format.

Counterpart of ``hydragnn_tpu/utils/checkpoint.py``. The files keep the
JAX package's layout and semantics:

- a run's files live in ``./logs/<log_name>/``;
- ``checkpoint.pt`` is the latest state, ``checkpoint_epoch<N>.pt`` the
  state saved on epoch ``N`` (``latest`` refreshed to the same bytes,
  then pruned to the newest ``keep``), ``resume.pt`` the writer's resume
  container;
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
a restore replay with the restored values.

An MD rollout's trajectory checkpoints (``simulate/engine.py``) go
through the same writer: the dict is ``{"md_state": {leaf: tensor}}``,
every leaf of the ``MDState``, and the rollout's policy ladder rides in
the manifest's ``loop`` slot, as the JAX engine writes it. The
validate-finite gate holds for it too.

The writer's files (``CheckpointWriter``) are the same dict with a
``"manifest"`` key added: the resume cursor ``(epoch, step)``, the plan
seed and ``config_fingerprint`` that guard it, the epoch's partial
metric sums as float32 bit patterns (``encode_acc``) and the loop's
host state (scheduler, early stopping, history). ``run_prediction``
and ``load_checkpoint`` ignore the key, and a file without it (a
synchronous save) restores as a checkpoint without a cursor
(``load_resume_checkpoint``).

Under several ranks every rank calls ``save_checkpoint`` (and the
writer's ``save``) together: an FSDP2-sharded model's parameters and
optimizer state are all-gathered into full tensors
(``parallel/runtime.gather_to_host``), so the file restores in one
process; rank 0 writes, and every rank waits at a barrier until the file
is in place. A restore into sharded tensors copies each rank's shard.

The sharded format (``Training.checkpoint_format: "orbax"``, the JAX
package's key) writes the port's own files in the layout and with the
crash semantics of the JAX package's orbax directories, with no gather:

- ``logs/<log_name>/orbax/`` holds the directories ``epoch_<N>``,
  ``final`` and ``autosave`` (the writer's resume container), and the
  pointer files ``LATEST`` (the newest epoch or final directory) and
  ``RESUME`` (the writer's newest), each written to a tmp file and
  moved into place;
- a directory holds ``rank<r>.pt`` per rank: that rank's local shard of
  each FSDP2 DTensor with its global offset (the first replica of a
  shard writes it), and on rank 0 every plain (replicated) tensor;
  ``meta.json``, each tensor's global shape, dtype and placements, the
  world size and the step count; and, for the writer,
  ``manifest.json``;
- a save writes ``.tmp_<name>``, renames the old directory to
  ``<name>.old``, renames the tmp into place, and then removes each
  ``.old`` whose stem exists again; a load falls back from a stale or
  corrupt ``LATEST`` to the newest restorable directory, and a resume
  from a missing ``RESUME`` target to ``<target>.old`` with its manifest;
- a restore at the saved world size and placements reads each shard
  from this rank's file; at another world size (``run_prediction(config)``
  in one process after a multi-rank run) it assembles each tensor from
  every rank's file;
- the ranks meet, and agree that the state is finite, on the process
  group's store (``store.add``/``set``/``wait`` under keys named by the
  writer and its job's enqueue-time sequence), never with a collective,
  so the writer's thread can save while the loop thread runs the
  step's collectives; at world 1 no store is touched.

Fault points (``utils/faults.py``) sit inside the write and the
publish, where the drills land their failures and kills
(``orbax_between_replaces`` between the sharded format's two renames).
"""

from __future__ import annotations

import glob
import hashlib
import io
import itertools
import json
import os
import queue
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hydragnn_tpu_torch.parallel.runtime import gather_to_host, rank, world_size
from hydragnn_tpu_torch.utils import faults, telemetry
from hydragnn_tpu_torch.utils import tracer as tr

CHECKPOINT_DIR = "./logs"
MANIFEST_VERSION = 1
_LATEST = "checkpoint.pt"
_RESUME = "resume.pt"
_EPOCH_RE = re.compile(r"checkpoint_epoch(\d+)\.pt$")
_BACKOFF_CAP_S = 30.0


def _warn(msg: str) -> None:
    print(f"[checkpoint] {msg}", flush=True)


@dataclass
class CheckpointSettings:
    """The resolved ``Training.Checkpoint`` block: ``true`` means
    save-on-best with the defaults; the object form adds the writer's
    knobs ``{"enabled", "async", "interval_steps", "retries", "backoff",
    "validate_finite"}``."""

    enabled: bool = False
    async_enabled: bool = True
    interval_steps: int = 0
    retries: int = 3
    backoff_s: float = 0.25
    validate_finite: bool = True


def checkpoint_settings(training: dict) -> CheckpointSettings:
    raw = training.get("Checkpoint", False)
    if isinstance(raw, dict):
        return CheckpointSettings(
            enabled=bool(raw.get("enabled", True)),
            async_enabled=bool(raw.get("async", True)),
            interval_steps=max(0, int(raw.get("interval_steps", 0))),
            retries=max(0, int(raw.get("retries", 3))),
            backoff_s=float(raw.get("backoff", 0.25)),
            validate_finite=bool(raw.get("validate_finite", True)),
        )
    return CheckpointSettings(enabled=bool(raw))


def _run_dir(log_name: str) -> str:
    return os.path.join(CHECKPOINT_DIR, log_name)


def _ckpt_path(log_name: str, epoch: Optional[int] = None, *, make: bool = True) -> str:
    d = _run_dir(log_name)
    if make:
        os.makedirs(d, exist_ok=True)
    return os.path.join(d, _LATEST if epoch is None else f"checkpoint_epoch{epoch}.pt")


def _epoch_files_newest_first(log_name: str) -> list:
    files = glob.glob(os.path.join(_run_dir(log_name), "checkpoint_epoch*.pt"))
    return sorted(files, key=lambda p: int(_EPOCH_RE.search(p).group(1)), reverse=True)


def _prune_old_epochs(log_name: str, keep: int) -> None:
    """Keep the newest ``keep`` per-epoch files (``keep`` <= 0 keeps all)."""
    for p in _epoch_files_newest_first(log_name)[keep:] if keep > 0 else []:
        try:
            os.remove(p)
        except OSError:
            pass


def _atomic_write_bytes(path: str, blob: bytes) -> None:
    """``blob`` at ``path`` through ``<path>.tmp`` and ``os.replace``.
    Half the bytes go out before the fault point, so an injected failure
    or crash leaves a truncated temporary file and ``path`` untouched,
    as a real one would."""
    tmp = path + ".tmp"
    half = max(len(blob) // 2, 1)
    # graftlint: disable-next-line=thread-discipline -- the sync-format fallback (Checkpoint.async false) writes on the caller thread BY DESIGN; the async path reaches here only on the worker thread
    with open(tmp, "wb") as f:
        f.write(blob[:half])
        faults.on_write(path)
        faults.crash_point("write_tmp")
        f.write(blob[half:])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _publish_linked(src: str, dst: str, blob: bytes) -> None:
    """``dst`` with the bytes of the just-written ``src``: a hard link
    moved into place (no second write), else a full atomic write."""
    tmp = dst + ".lnk"
    try:
        try:
            os.remove(tmp)
        except FileNotFoundError:
            pass
        os.link(src, tmp)
        faults.crash_point("publish_link")
        os.replace(tmp, dst)
    except OSError:
        _atomic_write_bytes(dst, blob)


def _full(tree):
    """``tree`` with every tensor whole on the host (module docstring)."""
    if isinstance(tree, torch.Tensor):
        return gather_to_host(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _full(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_full(v) for v in tree)
    return tree


_BARRIER_SEQ: dict = {}


def _barrier(site: str = "save") -> None:
    """Meet every rank (a no-op at world 1). Each crossing is a telemetry
    ``barrier`` row (its whole wait, also when the barrier raises) and a
    ``waiting_on`` site for the heartbeats; ``seq`` counts the site's
    crossings, which every rank makes alike."""
    if world_size() <= 1:
        return
    seq = _BARRIER_SEQ[site] = _BARRIER_SEQ.get(site, 0) + 1
    with telemetry.waiting_on(f"barrier:{site}"):
        t0 = time.perf_counter()
        try:
            dist.barrier()
        except BaseException:
            dt = time.perf_counter() - t0
            telemetry.emit_barrier(site, seq, dt, dt, timed_out=True)
            raise
        dt = time.perf_counter() - t0
    telemetry.emit_barrier(site, seq, dt, dt)


def _is_md_state(state) -> bool:
    from hydragnn_tpu_torch.simulate.state import MDState

    return isinstance(state, MDState)


def _state_tree(state) -> dict:
    """The checkpoint dict over a state's live tensors: a ``TrainState``'s
    model, optimizer and step, or an MD rollout's ``MDState`` leaf for
    leaf under ``"md_state"`` (the rollout's ladder rides in the
    manifest's ``loop`` slot)."""
    if _is_md_state(state):
        return {"md_state": state.leaves()}
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "step": int(state.step)}


def _blob(tree: dict) -> bytes:
    buf = io.BytesIO()
    torch.save(tree, buf)
    return buf.getvalue()


def save_checkpoint(log_name: str, state, *, epoch: Optional[int] = None,
                    keep: int = 0) -> str:
    """Write ``state`` (a ``TrainState``) now: the epoch file and
    ``latest`` with ``epoch``, else ``latest`` alone; then prune to the
    newest ``keep`` epoch files (0 keeps them all). Returns the path
    written. Every rank calls this; rank 0 writes (module docstring)."""
    blob = _blob(_full(_state_tree(state)))
    writer = rank() == 0
    path = _ckpt_path(log_name, epoch, make=writer)
    if writer:
        _atomic_write_bytes(path, blob)
        if epoch is not None:
            _atomic_write_bytes(_ckpt_path(log_name, None), blob)
            _prune_old_epochs(log_name, keep)
    _barrier()
    return path


def _restore_md_state(state, leaves: dict) -> None:
    """Set each leaf of an ``MDState`` to the saved tensor on the live
    leaf's device, bit for bit. The leaves are replaced, not copied into:
    a rollout saved after a capacity growth holds longer neighbor lists
    than a fresh engine's state (the ladder in the manifest says so)."""
    live = state.leaves()
    if set(live) != set(leaves):
        raise ValueError(
            f"checkpoint holds MD leaves {sorted(leaves)}, the state has {sorted(live)}"
        )
    for name, t in live.items():
        saved = leaves[name]
        if saved.dtype != t.dtype or saved.dim() != t.dim():
            raise ValueError(
                f"MD leaf {name}: saved {saved.dtype} {tuple(saved.shape)} does not fit "
                f"{t.dtype} {tuple(t.shape)}"
            )
    for name, t in live.items():
        setattr(state, name, leaves[name].to(t.device).clone())


def _restore_blob(state, blob: dict) -> None:
    """Copy a loaded checkpoint dict into ``state`` in place, bit for
    bit (module docstring); a ``"manifest"`` key is not read."""
    if _is_md_state(state):
        if "md_state" not in blob:
            raise ValueError("checkpoint holds a train state, not an MD rollout's")
        _restore_md_state(state, blob["md_state"])
        return
    if "md_state" in blob:
        raise ValueError("checkpoint holds an MD rollout's state, not a train state")
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
    state.set_step(int(blob["step"]))


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _try_restore(state, path: str) -> bool:
    """Restore ``path`` into ``state``, or warn and return False when it
    is missing or cannot be read."""
    if not os.path.exists(path):
        return False
    try:
        _restore_blob(state, _load(path))
        return True
    except Exception as e:  # a truncated or foreign file
        _warn(f"checkpoint at {path} is not restorable ({type(e).__name__}: {e}) "
              "— skipping it")
        return False


def load_checkpoint(log_name: str, state, *, epoch: Optional[int] = None, fmt: str = "pt"):
    """Restore a ``TrainState`` written by ``save_checkpoint`` or the
    writer into ``state`` (whose model and optimizer give the structure)
    and return it. With ``epoch`` that file is read and any failure
    raises; without, ``latest``, else the newest restorable epoch file
    (with a warning). ``fmt="orbax"``: ``load_checkpoint_sharded``."""
    if fmt == "orbax":
        return load_checkpoint_sharded(log_name, state, epoch=epoch)
    path = _ckpt_path(log_name, epoch, make=False)
    if epoch is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(f"No checkpoint at {path}")
        _restore_blob(state, _load(path))
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
    if (os.path.exists(os.path.join(_run_dir(log_name), _RESUME))
            or checkpoint_exists(log_name) or bool(_epoch_files_newest_first(log_name))):
        return True
    base = _orbax_base(log_name, make=False)
    return os.path.isdir(base) and any(os.scandir(base))


# ---------------------------------------------------------------- the manifest


def _peek_fingerprint(log_name: str) -> Optional[str]:
    """The ``config_fingerprint`` of ``log_name``'s resume container
    (its tensors memory-mapped, not read; the sharded format's ``RESUME``
    manifest), or None."""
    base = _orbax_base(log_name, make=False)
    target = _read_pointer(base, "RESUME")
    if target is not None:
        return (_read_manifest(os.path.join(base, target)) or {}).get("config_fingerprint")
    path = os.path.join(_run_dir(log_name), _RESUME)
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        return (blob.get("manifest") or {}).get("config_fingerprint")
    except Exception:
        return None


def find_continue_log_name(log_name: str, preferred: Optional[str] = None,
                           fingerprint: Optional[str] = None) -> str:
    """The run directory a ``continue`` (or a restore) reads. The
    derived name encodes ``num_epoch``, which a continue may extend, so:
    ``log_name`` when it has checkpoints; else the caller's in-flight
    ``preferred`` run; else the newest sibling differing only in the
    ``_e<N>`` suffix that has checkpoints, with a warning; else
    ``log_name``. With a ``fingerprint`` (this config's
    ``config_fingerprint``) a candidate whose resume container was
    written under another configuration is not adopted (it would become
    this run's write target), with a warning."""

    def adoptable(cand: str) -> bool:
        if fingerprint is None:
            return True
        stored = _peek_fingerprint(cand)
        if stored == fingerprint:
            return True
        _warn(f"Training.continue: not adopting '{cand}' — its stored config fingerprint "
              f"({stored}) does not match this config ({fingerprint}); continuing would "
              "overwrite a different run's artifacts")
        return False

    if _has_artifacts(log_name):
        return log_name
    if preferred and preferred != log_name and _has_artifacts(preferred) and adoptable(preferred):
        _warn(f"Training.continue: no checkpoint under '{log_name}' — continuing "
              f"'{preferred}' (this config's previous run)")
        return preferred
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
    cands.sort(key=lambda n: os.path.getmtime(_run_dir(n)), reverse=True)
    for cand in cands:
        if adoptable(cand):
            _warn(f"no checkpoint under '{log_name}' — using '{cand}' (same run name up to "
                  "num_epoch)")
            return cand
    return log_name


# Keys a resume may change without moving the batch plan the cursor
# addresses (the JAX package's list).
_FINGERPRINT_VOLATILE = frozenset({
    "continue", "num_epoch", "Checkpoint", "checkpoint_warmup", "checkpoint_keep",
    "walltime_min_seconds_left",
})


def config_fingerprint(config: dict) -> str:
    """A stable hash of the run's config, without ``_``-prefixed and
    resume-volatile keys at every depth: the JAX package's hex for the
    same config."""

    def strip(doc):
        if isinstance(doc, dict):
            return {k: strip(v) for k, v in sorted(doc.items())
                    if not str(k).startswith("_") and k not in _FINGERPRINT_VOLATILE}
        if isinstance(doc, (list, tuple)):
            return [strip(v) for v in doc]
        return doc

    canon = json.dumps(strip(config), sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def encode_acc(acc) -> Optional[dict]:
    """The epoch's partial sums ``(loss_sum, tasks_sum, n_graphs)`` as
    float32 bit patterns (one host copy), so a resumed epoch adds on from
    the interrupted run's exact values."""
    if acc is None or acc[0] is None:
        return None
    loss_sum, tasks_sum, n_graphs = (torch.as_tensor(a) for a in acc)
    flat = torch.cat([loss_sum.reshape(1).float(), tasks_sum.reshape(-1).float(),
                      n_graphs.to(loss_sum.device).reshape(1).float()])
    # graftlint: disable-next-line=host-sync -- part of the designed snapshot barrier: the epoch's partial sums, fetched once per save, not per step
    bits = flat.detach().cpu().numpy().astype(np.float32).view(np.uint32)
    return {"loss_sum": int(bits[0]), "tasks_sum": [int(v) for v in bits[1:-1]],
            "n_graphs": int(bits[-1])}


def decode_acc(enc: Optional[dict]) -> Optional[tuple]:
    """Inverse of ``encode_acc``: numpy float32 values."""
    if not enc:
        return None

    def val(bits: int):
        return np.asarray([bits], np.uint32).view(np.float32)[0]

    tasks = np.asarray(enc["tasks_sum"], np.uint32).view(np.float32)
    return val(enc["loss_sum"]), tasks, val(enc["n_graphs"])


def build_manifest(*, epoch: int, step: int = 0, plan_seed: Optional[int] = None,
                   fingerprint: Optional[str] = None, acc=None, loop: Optional[dict] = None,
                   fmt: str = "pt", branch_steps: Optional[list] = None) -> dict:
    """The resume cursor: training continues at ``(epoch, step)``, the
    first ``step`` optimizer steps of ``epoch`` being inside the saved
    state; ``plan_seed`` and ``fingerprint`` guard it, ``acc``
    (``encode_acc``) carries the epoch's partial sums, ``loop`` the
    loop's host state. ``branch_steps`` (multibranch) are the per-branch
    cursors, all ``step`` since the branches run in lockstep; a restore
    checks them rather than assume it."""
    return {"version": MANIFEST_VERSION, "epoch": int(epoch), "step": int(step),
            "plan_seed": None if plan_seed is None else int(plan_seed),
            "config_fingerprint": fingerprint, "acc": acc, "loop": loop, "format": fmt,
            "branch_steps": None if branch_steps is None else [int(b) for b in branch_steps],
            "unix_time": time.time()}


def load_resume_checkpoint(log_name: str, state, *, fmt: str = "pt"):
    """Restore the newest durable state for ``Training.continue`` (a
    ``TrainState``) or for a resumed MD rollout (an ``MDState``) into
    ``state``: the writer's resume container (state and manifest in one
    file), else ``latest`` or an epoch file with no cursor. Returns
    ``(state, manifest or None)``. ``fmt="orbax"``:
    ``load_resume_checkpoint_sharded``."""
    if fmt == "orbax":
        return load_resume_checkpoint_sharded(log_name, state)
    path = os.path.join(_run_dir(log_name), _RESUME)
    if os.path.exists(path):
        try:
            blob = _load(path)
            _restore_blob(state, blob)
            return state, blob.get("manifest")
        except Exception as e:
            _warn(f"resume container {path} unreadable ({type(e).__name__}: {e}) — "
                  "falling back to the latest plain checkpoint (epoch-boundary resume)")
    return load_checkpoint(log_name, state), None


# ---------------------------------------------------------------- the sharded format


# ``Training.checkpoint_format: "orbax"`` under the JAX package's key:
# the port's own files in orbax's layout and with its crash semantics.
ORBAX_DIR = "orbax"
_META = "meta.json"
_MANIFEST = "manifest.json"
_STORE_TIMEOUT_S = 600.0
# numbers for store keys; every rank makes the same writers and sync
# saves in the same order, so the numbers agree with no exchange
_WRITERS = itertools.count(1)
_SYNC_SAVES = itertools.count(1)


def checkpoint_format(training: dict) -> str:
    """``Training.checkpoint_format``: ``"orbax"`` (the sharded format)
    or the ``.pt`` format (the default; the JAX package's
    ``"msgpack"`` names it too)."""
    fmt = str(training.get("checkpoint_format", "pt"))
    return "orbax" if fmt == "orbax" else "pt"


def _orbax_base(log_name: str, make: bool = True) -> str:
    d = os.path.abspath(os.path.join(_run_dir(log_name), ORBAX_DIR))
    if make:
        os.makedirs(d, exist_ok=True)
    return d


def _read_pointer(base: str, name: str) -> Optional[str]:
    try:
        with open(os.path.join(base, name)) as f:
            return f.read().strip() or None
    except OSError:
        return None


def _write_pointer(base: str, name: str, target: str) -> None:
    """``base/name`` holding ``target``, through a tmp file and
    ``os.replace``."""
    pointer = os.path.join(base, name)
    # graftlint: disable-next-line=thread-discipline -- pointer swap: a few bytes, shared by the worker and the designed sync fallback
    with open(pointer + ".tmp", "w") as f:
        f.write(target)
        f.flush()
        os.fsync(f.fileno())
    os.replace(pointer + ".tmp", pointer)


def _orbax_candidates(base: str, primary: str) -> list:
    """Restore order: ``primary``, then every other checkpoint directory
    (``final``, ``epoch_*``, ``autosave`` and their ``.old`` crash
    leftovers), newest first."""
    try:
        names = os.listdir(base)
    except OSError:
        return [primary]
    dirs = []
    for n in names:
        p = os.path.join(base, n)
        stem = n[:-4] if n.endswith(".old") else n
        if (p != primary and os.path.isdir(p) and not n.startswith(".tmp")
                and (stem in ("final", "autosave") or stem.startswith("epoch_"))):
            dirs.append(p)
    dirs.sort(key=os.path.getmtime, reverse=True)
    return [primary] + dirs


def _sweep_stale_old_dirs(base: str) -> None:
    """Remove each ``<name>.old`` whose ``<name>`` exists again; a
    ``.old`` whose stem is missing is the only copy of its artifact."""
    for n in os.listdir(base):
        if n.endswith(".old") and os.path.isdir(os.path.join(base, n[:-4])):
            shutil.rmtree(os.path.join(base, n), ignore_errors=True)


def _prune_orbax_epochs(base: str, keep: int) -> None:
    """Keep the newest ``keep`` ``epoch_*`` directories (``.old``
    leftovers are the sweep's)."""
    if keep <= 0:
        return
    eps = sorted(int(n.split("_")[1]) for n in os.listdir(base)
                 if re.fullmatch(r"epoch_\d+", n))
    for e in eps[:-keep]:
        shutil.rmtree(os.path.join(base, f"epoch_{e}"), ignore_errors=True)


def _tensor_leaves(tree, path: str = ""):
    """``(path, tensor)`` for every tensor of a nested dict/list, the
    path joining the keys with ``/``."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, f"{path}/{i}" if path else str(i))


def _placement_names(t) -> Optional[list]:
    """A DTensor's placements as strings (None for a plain tensor)."""
    return [str(p) for p in t.placements] if hasattr(t, "placements") else None


def _shard_offsets(t) -> list:
    """The global offset of a DTensor's local shard, dim by dim: each
    sharded mesh dimension splits what is left of its tensor dimension
    as ``torch.chunk`` does (DTensor's ``Shard``)."""
    offsets, lengths = [0] * t.dim(), list(t.shape)
    coord = t.device_mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if not p.is_shard():
            continue
        d, n = p.dim, t.device_mesh.size(i)
        chunk = -(-lengths[d] // n)
        start = min(coord[i] * chunk, lengths[d])
        offsets[d] += start
        lengths[d] = max(0, min(chunk, lengths[d] - start))
    if lengths != list(t.to_local().shape):
        raise ValueError(f"DTensor shard {list(t.to_local().shape)} is not the chunk "
                         f"{lengths} of {list(t.shape)} over {t.placements}")
    return offsets


def _sharded_snapshot(tree) -> dict:
    """This rank's part of a checkpoint dict over live tensors, on the
    host: each DTensor's local shard (where this rank is the first of its
    replicas) with its global offset, and, on rank 0 alone, every plain
    (replicated) tensor; ``info`` gives every tensor's global shape,
    dtype and placements, ``step`` the step count. No collective."""
    r = rank()
    pieces, offsets, info = {}, {}, {}
    for key, t in _tensor_leaves(tree):
        names = _placement_names(t)
        info[key] = {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
                     "placements": names}
        if names is None:
            if r == 0:
                pieces[key], offsets[key] = t.detach(), [0] * t.dim()
            continue
        coord = t.device_mesh.get_coordinate()
        if all(c == 0 for c, p in zip(coord, t.placements) if not p.is_shard()):
            pieces[key], offsets[key] = t.to_local().detach(), _shard_offsets(t)
    return {"pieces": _host_snapshot(pieces), "offsets": offsets, "info": info,
            "step": int(tree["step"])}


def _store():
    return dist.distributed_c10d._get_default_store()


def _store_meet(site: str, key: str, seq: int, bad: bool = False) -> int:
    """Meet every rank on the process group's store (never a collective,
    so a writer thread may call it while the loop thread runs the
    step's), adding ``bad`` to a count every rank reads after the
    meeting; returns the count (0 at world 1, where no store is
    touched). ``key`` names the meeting uniquely across jobs. A
    telemetry ``barrier`` row times it, also when it raises."""
    if world_size() <= 1:
        return int(bad)
    from datetime import timedelta

    store = _store()
    with telemetry.waiting_on(f"barrier:{site}"):
        t0 = time.perf_counter()
        try:
            store.add(f"{key}/bad", int(bad))
            if store.add(f"{key}/arrived", 1) == world_size():
                store.set(f"{key}/open", "1")
            store.wait([f"{key}/open"], timedelta(seconds=_STORE_TIMEOUT_S))
            total = int(store.add(f"{key}/bad", 0))
        except BaseException:
            dt = time.perf_counter() - t0
            telemetry.emit_barrier(site, seq, dt, dt, timed_out=True)
            raise
        dt = time.perf_counter() - t0
    telemetry.emit_barrier(site, seq, dt, dt)
    return total


def _write_sharded_dir(base: str, name: str, snap: dict, manifest: Optional[dict],
                       key: str, seq: int, site: str) -> int:
    """Every rank's shards of ``snap`` into ``base/name``, crash-safely:
    rank 0 opens ``.tmp_<name>``; each rank writes its file there; rank 0
    adds the metadata (and the manifest), renames the old directory to
    ``<name>.old``, the tmp into place, and sweeps the ``.old``
    directories whose stem exists again. The ranks meet on the store
    (``_store_meet``) after the opening, after the shard writes (a rank
    that failed its write stops the publish on every rank) and after the
    publish. Returns the bytes this rank wrote."""
    final_path = os.path.join(base, name)
    tmp = os.path.join(base, f".tmp_{name}")
    r = rank()
    err: Optional[BaseException] = None
    n_bytes = 0

    def phase(fn):
        nonlocal err
        if err is None:
            try:
                fn()
            except BaseException as e:  # the peers still meet this rank
                err = e

    def open_tmp():
        if r == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)

    def write_shards():
        nonlocal n_bytes
        blob = _blob({"pieces": snap["pieces"], "offsets": snap["offsets"]})
        _atomic_write_bytes(os.path.join(tmp, f"rank{r}.pt"), blob)
        n_bytes += len(blob)

    def publish():
        nonlocal n_bytes
        if r != 0:
            return
        meta = json.dumps({"version": MANIFEST_VERSION, "world_size": world_size(),
                           "step": snap["step"], "tensors": snap["info"]}).encode()
        _atomic_write_bytes(os.path.join(tmp, _META), meta)
        n_bytes += len(meta)
        if manifest is not None:
            mj = json.dumps(manifest).encode()
            _atomic_write_bytes(os.path.join(tmp, _MANIFEST), mj)
            n_bytes += len(mj)
        if os.path.exists(final_path):
            os.replace(final_path, final_path + ".old")
        faults.crash_point("orbax_between_replaces")
        os.replace(tmp, final_path)
        _sweep_stale_old_dirs(base)

    phase(open_tmp)
    _store_meet(f"open:{site}", f"{key}/open", seq, err is not None)
    phase(write_shards)
    if _store_meet(f"shards:{site}", f"{key}/shards", seq, err is not None) and err is None:
        err = OSError(f"a peer rank failed its shard write into {tmp}; not published")
    phase(publish)
    _store_meet(f"publish:{site}", f"{key}/publish", seq, err is not None)
    if err is not None:
        raise err
    return n_bytes


def save_checkpoint_sharded(log_name: str, state, *, epoch: Optional[int] = None,
                            keep: int = 0) -> str:
    """Write ``state`` now in the sharded format: every rank its own
    shards, no gather, into ``orbax/final`` (or ``orbax/epoch_<N>``), then
    the ``LATEST`` pointer and pruning to ``keep`` epoch directories.
    Every rank calls this; returns the directory."""
    base = _orbax_base(log_name)
    name = "final" if epoch is None else f"epoch_{epoch}"
    seq = next(_SYNC_SAVES)
    snap = _sharded_snapshot(_state_tree(state))
    _write_sharded_dir(base, name, snap, None, f"hgtpu_ckpt/sync/{seq}", seq,
                       f"save:{log_name}")
    if rank() == 0:
        _write_pointer(base, "LATEST", name)
        _prune_orbax_epochs(base, keep)
    return os.path.join(base, name)


def _restore_sharded_dir(state, path: str) -> None:
    """Copy a sharded directory into ``state`` in place, bit for bit.
    Under the world size and placements it was written with, each
    DTensor takes its shard from this rank's file alone (the replicated
    tensors from rank 0's); otherwise each tensor is assembled whole from
    every rank's file and copied in (an unsharded model takes it whole,
    a sharded one its own shard)."""
    from hydragnn_tpu_torch.train.optimizer import copy_into

    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    live = dict(_tensor_leaves(_state_tree(state)))
    saved = meta["tensors"]
    if set(live) != set(saved):
        raise ValueError(f"{path} holds another state's tensors")
    for k, t in live.items():
        want = (saved[k]["shape"], saved[k]["dtype"])
        if want != (list(t.shape), str(t.dtype).replace("torch.", "")):
            raise ValueError(f"{path}: {k} is {want}, the live tensor {list(t.shape)} {t.dtype}")
    files: dict = {}

    def rank_file(r: int) -> dict:
        if r not in files:
            files[r] = torch.load(os.path.join(path, f"rank{r}.pt"), map_location="cpu",
                                  weights_only=True, mmap=True)
        return files[r]

    same_world = int(meta["world_size"]) == world_size()
    mine = rank_file(rank()) if same_world else None
    with torch.no_grad():
        for k, t in live.items():
            names = saved[k]["placements"]
            if same_world and names is not None and names == _placement_names(t) \
                    and k in mine["pieces"]:
                t.to_local().copy_(mine["pieces"][k])
            elif names is None:
                copy_into(t, rank_file(0)["pieces"][k])
            else:
                full = torch.empty(saved[k]["shape"], dtype=t.dtype)
                for r in range(int(meta["world_size"])):
                    f = rank_file(r)
                    if k in f["pieces"]:
                        piece = f["pieces"][k]
                        at = tuple(slice(o, o + n)
                                   for o, n in zip(f["offsets"][k], piece.shape))
                        full[at] = piece
                copy_into(t, full)
    state.set_step(int(meta["step"]))


def _orbax_target(base: str, epoch: Optional[int]) -> str:
    if epoch is not None:
        return os.path.join(base, f"epoch_{epoch}")
    return os.path.join(base, _read_pointer(base, "LATEST") or "final")


def load_checkpoint_sharded(log_name: str, state, *, epoch: Optional[int] = None):
    """Restore a sharded checkpoint into ``state`` and return it: with
    ``epoch`` that directory, raising on any failure; without, the
    ``LATEST`` pointer's, and where it is stale or not restorable the
    newest restorable directory, with a warning."""
    base = _orbax_base(log_name, make=False)
    path = _orbax_target(base, epoch)
    if epoch is not None:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"No sharded checkpoint at {path}")
        _restore_sharded_dir(state, path)
        return state
    for cand in _orbax_candidates(base, path):
        if not os.path.isdir(cand):
            if cand == path:
                _warn(f"LATEST pointer targets missing dir {path} — falling back to the "
                      "newest restorable checkpoint")
            continue
        try:
            _restore_sharded_dir(state, cand)
        except Exception as e:
            _warn(f"sharded checkpoint at {cand} is not restorable ({type(e).__name__}: {e}) "
                  "— skipping it")
            continue
        if cand != path:
            _warn(f"falling back to sharded checkpoint {cand}")
        return state
    raise FileNotFoundError(f"No restorable sharded checkpoint under {base}")


def _read_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_resume_checkpoint_sharded(log_name: str, state):
    """The sharded format's ``load_resume_checkpoint``: the ``RESUME``
    pointer's directory with its manifest (and, where a kill between the
    two renames left it missing, ``<target>.old`` with its own), else
    ``load_checkpoint_sharded`` without a cursor. Returns ``(state,
    manifest or None)``."""
    base = _orbax_base(log_name, make=False)
    target = _read_pointer(base, "RESUME")
    if target is not None:
        for cand in (target, target + ".old"):
            path = os.path.join(base, cand)
            manifest = _read_manifest(path)
            if manifest is None:
                continue
            try:
                _restore_sharded_dir(state, path)
            except Exception as e:
                _warn(f"resume checkpoint {path} unrestorable ({type(e).__name__}: {e}) — "
                      "trying older artifacts")
                continue
            if cand != target:
                _warn(f"RESUME pointer targets missing {target} — resuming from {cand} (a "
                      "kill landed between the swap renames), cursor intact")
            return state, manifest
        _warn(f"RESUME pointer targets {target} with no restorable manifest — falling back "
              "(epoch-boundary resume)")
    return load_checkpoint_sharded(log_name, state), None


# ---------------------------------------------------------------- the writer


def nonfinite_leaves(host, path: str = "") -> list:
    """``[(path, bad_count, size), ...]`` for every floating host tensor
    of a nested dict/list holding NaN or Inf."""
    if isinstance(host, torch.Tensor):
        if not host.is_floating_point():
            return []
        bad = int(host.numel() - int(torch.isfinite(host).sum()))
        return [(path, bad, int(host.numel()))] if bad else []
    if isinstance(host, dict):
        items = host.items()
    elif isinstance(host, (list, tuple)):
        items = enumerate(host)
    else:
        return []
    return [leaf for k, v in items for leaf in nonfinite_leaves(v, f"{path}[{k!r}]")]


class _Slot(int):
    """A leaf's index in ``_host_snapshot``'s list (apart from the ints
    a checkpoint dict holds)."""


def _host_snapshot(tree):
    """``tree`` (a checkpoint dict over live tensors) on the host: the
    tensors of each dtype on one device gathered into one buffer and
    copied in one transfer (an FSDP2 shard all-gathered first), then
    split into tensors of their own. Returns only after the copies
    landed, so the next step may overwrite the live tensors."""
    leaves = []

    def walk(t, leaf):
        if isinstance(t, dict):
            return type(t)((k, walk(v, leaf)) for k, v in t.items())
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, leaf) for v in t)
        return leaf(t)

    def collect(t):
        if not isinstance(t, torch.Tensor):
            return t
        leaves.append(t)
        return _Slot(len(leaves) - 1)

    shape = walk(tree, collect)
    host: list = [None] * len(leaves)
    groups: dict = {}
    for i, t in enumerate(leaves):
        t = gather_to_host(t) if hasattr(t, "full_tensor") else t.detach()
        if t.device.type == "cpu":
            host[i] = t.clone()
        else:
            groups.setdefault((t.device, t.dtype), []).append((i, t))
    for members in groups.values():
        # graftlint: disable-next-line=host-sync -- the designed snapshot barrier: one copy per device and dtype, once per save; serialize+write then run off-thread
        flat = torch.cat([t.reshape(-1) for _, t in members]).cpu()
        at = 0
        for i, t in members:
            host[i] = flat[at:at + t.numel()].view(t.shape).clone()
            at += t.numel()
    return walk(shape, lambda t: host[t] if type(t) is _Slot else t)


def _processes_agree_finite(local_ok: bool, site: str = "finite", seq: int = 0) -> bool:
    """Every rank's validate-finite verdict, AND-ed (a MIN all-reduce
    on the loop thread); one rank's own verdict at world 1. The
    agreement is a telemetry ``barrier`` row at ``site``."""
    if world_size() == 1:
        return local_ok
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == dist.Backend.NCCL else torch.device("cpu"))
    flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32, device=dev)
    with telemetry.waiting_on(site):
        t0 = time.perf_counter()
        try:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            # graftlint: disable-next-line=host-sync -- the ranks' agreement flag after the MIN all-reduce: one int per save (validate-finite), never per step
            ok = bool(flag.item())
        except BaseException:
            dt = time.perf_counter() - t0
            telemetry.emit_barrier(site, seq, dt, dt, timed_out=True)
            raise
        dt = time.perf_counter() - t0
    telemetry.emit_barrier(site, seq, dt, dt)
    return ok


class CheckpointWriter:
    """Asynchronous, crash-safe checkpoint saves (the JAX package's
    ``CheckpointWriter``).

    ``save`` has two phases. On the caller's (the loop's) thread, under
    ``train/capture.GRAPH_LOCK``: the state's tensors are copied to the
    host (``_host_snapshot``: one transfer per dtype, finished before
    ``save`` returns, so the next step's in-place update cannot reach
    the copy), and, under several ranks, an FSDP2 model gathered and
    the ranks' validate-finite verdicts agreed (both collectives). On
    one worker thread, which touches host memory only (no CUDA call, no
    collective): the validate-finite gate (a state holding NaN or Inf is
    never written, ``rejected_saves`` counts it), ``torch.save`` and the
    atomic writes, with transient ``OSError``s retried ``retries`` times
    at a doubling ``backoff_s``; a failure past them is printed and kept
    on ``last_error``, never raised into training. One write is in
    flight at a time: a ``save`` arriving while one is pending waits for
    it (the next snapshot waits, not the steps between saves). Rank 0
    writes; ``wait`` and ``close`` end at a barrier of every rank.

    ``fmt="orbax"`` writes the sharded format (module docstring): the
    snapshot copies this rank's shards alone (no gather, no collective),
    and every rank's worker thread writes its file, the ranks agreeing
    on the validate-finite verdict and meeting around the publish on the
    store; a write across ranks is tried once (its meetings are named by
    the job), one rank's alone takes the retries.

    ``kind``: ``"auto"`` writes the resume container (``resume.pt``)
    alone; ``"epoch"`` the container, the epoch file and ``latest`` (a
    hard link of the epoch file), pruning epoch files to ``keep``;
    ``"final"`` the container and ``latest``. Every file holds the same
    bytes: the checkpoint dict with the manifest. The sharded format
    writes the directory ``autosave``, ``epoch_<N>`` or ``final`` and
    points ``RESUME`` at it (and ``LATEST`` for the latter two).

    Counts: ``saves``, ``bytes_written``, ``retries``,
    ``snapshot_ms`` (each save's caller-thread time), ``write_ms``.
    """

    def __init__(self, log_name: str, *, keep: int = 0, retries: int = 3,
                 backoff_s: float = 0.25, async_enabled: bool = True,
                 plan_seed: Optional[int] = None, fingerprint: Optional[str] = None,
                 validate_finite: bool = True, fmt: str = "pt"):
        self.log_name = log_name
        self.fmt = fmt
        self._gen = next(_WRITERS)  # names this writer's store keys apart
        self.keep = int(keep)
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))
        self.async_enabled = bool(async_enabled)
        self.plan_seed = plan_seed
        self.fingerprint = fingerprint
        self.validate_finite = bool(validate_finite)
        self.rejected_saves = 0
        self.last_error: Optional[BaseException] = None
        self.saves = 0
        self.bytes_written = 0
        self.retried = 0
        self.snapshot_ms: list = []
        self.write_ms: list = []
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0
        self._cv = threading.Condition()
        self._job_seq = 0

    def save(self, state, *, kind: str = "auto", epoch: int = 0, step: int = 0,
             label_epoch: Optional[int] = None, acc=None, loop: Optional[dict] = None,
             branch_steps: Optional[list] = None) -> None:
        """``(epoch, step)`` is the resume cursor, the next step to run
        (an end-of-epoch save of epoch e carries ``(e + 1, 0)``);
        ``label_epoch`` names the epoch file (``kind="epoch"``),
        defaulting to ``epoch``; ``branch_steps`` the multibranch
        per-branch cursors (``build_manifest``)."""
        from hydragnn_tpu_torch.train.capture import GRAPH_LOCK

        tw = time.perf_counter()
        self._drain()
        t0 = time.perf_counter()
        waited = t0 - tw
        if waited > 1e-4:
            tr.sample("checkpoint/backpressure_ms", 1e3 * waited)
        sharded = self.fmt == "orbax"
        with GRAPH_LOCK:
            tree = _state_tree(state)
            host = _sharded_snapshot(tree) if sharded else _host_snapshot(tree)
            manifest = build_manifest(epoch=epoch, step=step, plan_seed=self.plan_seed,
                                      fingerprint=self.fingerprint, acc=encode_acc(acc),
                                      loop=loop, fmt=self.fmt, branch_steps=branch_steps)
        finite = None
        self._job_seq += 1
        if world_size() > 1 and self.validate_finite and not sharded:
            finite = _processes_agree_finite(not nonfinite_leaves(host),
                                             f"finite:{self.log_name}", self._job_seq)
        snap_ms = 1e3 * (time.perf_counter() - t0)
        self.snapshot_ms.append(snap_ms)
        tr.sample("checkpoint/snapshot_block_ms", snap_ms)
        telemetry.emit({"t": "checkpoint", "event": "save", "kind": kind,
                        "epoch": int(epoch), "step": int(step),
                        "snapshot_block_ms": round(snap_ms, 3),
                        "backpressure_ms": round(1e3 * waited, 3),
                        "async": self.async_enabled})
        host["manifest"] = manifest
        job = (host, kind, epoch if label_epoch is None else int(label_epoch), finite,
               self._job_seq)
        if rank() != 0 and not sharded:
            if finite is False:
                self.rejected_saves += 1
            return
        if not self.async_enabled:
            self._run_job(job)
            return
        with self._cv:
            self._inflight += 1
        self._ensure_thread()
        self._queue.put_nowait(job)

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._worker_main, daemon=True,
                                        name="hgtpu-ckpt-writer")
        self._thread.start()

    def _worker_main(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._run_job(job)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _run_job(self, job) -> None:
        host, kind, epoch, finite, seq = job
        sharded = self.fmt == "orbax"
        if finite is None and self.validate_finite:
            finite = not nonfinite_leaves(host["pieces"] if sharded else host)
            if sharded:  # every rank scanned its own shards: agree
                finite = _store_meet(f"finite:{self.log_name}", self._key(seq, "finite"),
                                     seq, bad=not finite) == 0
        if self.validate_finite and not finite:
            self.rejected_saves += 1
            _warn(f"checkpoint save REJECTED (kind={kind}, epoch={epoch}): the state "
                  "contains non-finite values — refusing to publish a corrupt artifact; "
                  "the last durable checkpoint remains the resume/rollback point "
                  "(Training.Checkpoint.validate_finite disables this gate)")
            tr.sample("checkpoint/rejected_saves", 1.0)
            telemetry.emit({"t": "checkpoint", "event": "rejected", "kind": kind,
                            "epoch": int(epoch), "reason": "non_finite_state"})
            return
        t0 = time.perf_counter()
        delay = self.backoff_s
        blob = None
        n_bytes = 0
        # a write across ranks meets them under this job's names once
        retries = 0 if sharded and world_size() > 1 else self.retries
        for attempt in range(retries + 1):
            try:
                if sharded:
                    n_bytes = self._emit_sharded(host, kind, epoch, seq)
                else:
                    if blob is None:
                        blob = _blob(host)
                    n_bytes = self._emit(kind, epoch, blob)
                self.bytes_written += n_bytes
                self.saves += 1
                self.last_error = None
                break
            except OSError as e:
                if attempt == retries:
                    self.last_error = e
                    _warn(f"checkpoint write FAILED after {attempt + 1} attempt(s): {e} — "
                          "training continues; the last durable checkpoint remains the "
                          "resume point")
                    break
                self.retried += 1
                _warn(f"transient checkpoint write failure ({e}); retrying in {delay:.2f}s")
                # graftlint: disable-next-line=thread-discipline -- retry backoff: worker-thread path (or the designed sync fallback) waiting out a transient write failure
                time.sleep(delay)
                delay = min(delay * 2.0, _BACKOFF_CAP_S)
            except BaseException as e:
                # an injected crash included: a real kill ends the process
                # anyway, and the tests read what it left on disk
                if (isinstance(e, (KeyboardInterrupt, SystemExit))
                        and threading.current_thread() is not self._thread):
                    raise
                self.last_error = e
                _warn(f"checkpoint write FAILED (non-retryable): {e!r}")
                break
        write_ms = 1e3 * (time.perf_counter() - t0)
        self.write_ms.append(write_ms)
        tr.sample("checkpoint/serialize_write_ms", write_ms)
        if n_bytes:
            tr.sample("checkpoint/bytes", float(n_bytes))
        telemetry.emit({"t": "checkpoint", "event": "write", "kind": kind,
                        "epoch": int(epoch), "serialize_write_ms": round(write_ms, 3),
                        "bytes": int(n_bytes), "failed": self.last_error is not None})

    def _emit(self, kind: str, epoch: int, blob: bytes) -> int:
        d = _run_dir(self.log_name)
        os.makedirs(d, exist_ok=True)
        _atomic_write_bytes(os.path.join(d, _RESUME), blob)
        n = len(blob)
        if kind == "epoch":
            epoch_path = _ckpt_path(self.log_name, epoch)
            _atomic_write_bytes(epoch_path, blob)
            _publish_linked(epoch_path, _ckpt_path(self.log_name, None), blob)
            _prune_old_epochs(self.log_name, self.keep)
            n += len(blob)
        elif kind == "final":
            _atomic_write_bytes(_ckpt_path(self.log_name, None), blob)
            n += len(blob)
        return n

    def _key(self, seq: int, what: str) -> str:
        """A store key of job ``seq``: every rank makes the same writers
        and enqueues the same saves in the same order, so the names
        agree with no exchange and no job reuses another's."""
        return f"hgtpu_ckpt/{self._gen}/{seq}/{what}"

    def _emit_sharded(self, host: dict, kind: str, epoch: int, seq: int) -> int:
        base = _orbax_base(self.log_name)
        name = {"auto": "autosave", "epoch": f"epoch_{epoch}", "final": "final"}[kind]
        n = _write_sharded_dir(base, name, host, host["manifest"], self._key(seq, name), seq,
                               self.log_name)
        if rank() == 0:
            _write_pointer(base, "RESUME", name)
            if kind in ("epoch", "final"):
                _write_pointer(base, "LATEST", name)
            if kind == "epoch":
                _prune_orbax_epochs(base, self.keep)
        return n

    def _drain(self) -> None:
        with self._cv:
            while self._inflight:
                # graftlint: disable-next-line=thread-discipline -- single-writer backpressure: bounded by the ONE in-flight job (measured as checkpoint/backpressure_ms), and the worker signals on every exit path
                self._cv.wait()

    def wait(self) -> None:
        """Block until no write is in flight, on every rank."""
        self._drain()
        _barrier(f"publish:{self.log_name}")

    def close(self, barrier: bool = True) -> None:
        """Drain, stop the worker and, with ``barrier``, meet the other
        ranks (a rank leaving on an error skips it). Never raises on a
        write failure (see ``last_error``)."""
        self._drain()
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=30.0)
        self._thread = None
        if barrier:
            _barrier("final_checkpoint")

    def stats(self) -> dict:
        """The counts (class docstring) as one dict."""
        return {"saves": self.saves, "bytes": self.bytes_written, "retries": self.retried,
                "rejected": self.rejected_saves, "snapshot_ms": list(self.snapshot_ms),
                "write_ms": list(self.write_ms),
                "last_error": None if self.last_error is None else repr(self.last_error)}
