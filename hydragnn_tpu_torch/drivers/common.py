"""What the example drivers share: their configs' paths, the
``--config``/``--device`` arguments, the run and its report, the
energy normalization of ``examples/common/loaders.py``, and the ranks of
the multi-process drivers (``launched``, ``join``, ``spawn``).

Each driver reads its JSON config from the repository's ``examples/``
tree by path (the reference scripts' own files, read and never copied or
edited; ``--config`` names another) and runs on the card unless
``--device`` names another device (``device.resolve_device``: ``cuda``
without a card raises). ``main(argv)`` of each driver returns what it
printed as numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def example_path(*parts: str) -> str:
    """A file of the repository's ``examples/`` tree."""
    return os.path.join(REPO, "examples", *parts)


class _Parser(argparse.ArgumentParser):
    """Resolves ``--config`` after parsing where a flag picks between two
    example configs."""

    alt = None

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if self.alt is not None and ns.config is None:
            flag, on, off = self.alt
            ns.config = example_path(*(on if getattr(ns, flag) else off))
        return ns


def parser(description: str, config: Optional[Sequence[str]] = None,
           alt: Optional[Tuple[str, str, Sequence[str]]] = None) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` and, where the driver reads
    one, ``--config`` defaulting to ``examples/<config...>``. ``alt`` =
    (flag, help, config) adds the reference's ``--<flag>``, which makes
    ``examples/<config...>`` the default instead."""
    ap = _Parser(description=description)
    if alt is not None:
        flag, text, on = alt
        ap.add_argument(f"--{flag}", action="store_true", help=text)
        ap.alt = (flag, on, config)
        ap.add_argument("--config", default=None,
                        help=f"the JSON config (default: examples/{'/'.join(config)}, or "
                        f"examples/{'/'.join(on)} with --{flag})")
    elif config is not None:
        ap.add_argument("--config", default=example_path(*config),
                        help="the JSON config (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card, cuda:LOCAL_RANK)")
    return ap


def device(args):
    """The run's device; without a card ``cuda`` raises here, before any
    data is made."""
    from hydragnn_tpu_torch.device import resolve_device

    return resolve_device(args.device)


def example_config(args) -> dict:
    """The driver's ``--config`` with ``num_epoch`` set to ``--epochs``."""
    from hydragnn_tpu_torch.config import load_config

    config = load_config(args.config)
    config["NeuralNetwork"]["Training"]["num_epoch"] = args.epochs
    return config


def split(samples):
    """The reference drivers' 0.8 / 0.1 / 0.1 split."""
    from hydragnn_tpu_torch.data.loader import split_dataset

    return split_dataset(samples, 0.8)


def train(config, splits, dev):
    """``run_training`` on the three splits at seed 0, as the reference
    drivers call it: (state, model, cfg, hist, full config)."""
    import hydragnn_tpu_torch as port

    return port.run_training(config, datasets=tuple(splits), seed=0, device=dev)


def with_force_loss(hist, out: dict) -> dict:
    """Prints the last epoch's test force loss (a potential's per-task
    losses are [energy, energy per atom, forces]) and adds it to
    ``out``."""
    tasks = np.asarray(hist.test_tasks[-1]).reshape(-1)
    print(f"test force loss {tasks[-1]:.5f}")
    out["test_force_loss"] = float(tasks[-1])
    return out


def energy_mean_std(samples) -> Tuple[float, float]:
    """Mean and standard deviation (at least 1e-6) of the energies."""
    e = np.array([s.energy for s in samples])
    return float(e.mean()), float(max(e.std(), 1e-6))


def normalized_energy_targets(samples) -> List:
    """Copies of ``samples`` with the z-scored energy written to
    ``y_graph`` (energy only, for force-free graph-head configs)."""
    import dataclasses

    mu, sd = energy_mean_std(samples)
    return [dataclasses.replace(s, y_graph=np.array([(s.energy - mu) / sd], np.float32))
            for s in samples]


def final_losses(hist) -> dict:
    """Prints the reference drivers' ``final:`` line and returns its
    numbers."""
    out = {"train_loss": float(hist.train_loss[-1]), "val_loss": float(hist.val_loss[-1]),
           "test_loss": float(hist.test_loss[-1])}
    print(f"final: train {out['train_loss']:.5f} val {out['val_loss']:.5f} "
          f"test {out['test_loss']:.5f}")
    return out


def rollout_numbers(res) -> dict:
    """A rollout's report numbers: steps, dt, rebuilds, steps/s, events
    and the total energy's largest departure from its start."""
    total = np.asarray(res.energies) + np.asarray(res.kinetic)
    return {"steps": int(res.stats["steps"]), "dt": float(res.stats["dt"]),
            "rebuilds": int(res.stats["rebuilds"]),
            "steps_per_sec": float(res.stats["steps_per_sec"]),
            "events": list(res.stats["events"]),
            "energy_drift": float(np.max(np.abs(total - total[0]))) if total.size else 0.0,
            "finite": bool(np.isfinite(total).all())}


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join(args):
    """This process's rank of a multi-process driver: a spawned one
    (``args.rank`` set) joins the FileStore ``args.store`` of
    ``args.ranks`` ranks, a launched one the group its variables name,
    any other a group of one. On cards each rank takes ``cuda:LOCAL_RANK``
    modulo the visible cards: NCCL with a card per rank, else gloo (ranks
    sharing a card, where NCCL refuses two ranks on one device). Returns
    (device, backend)."""
    import torch
    import torch.distributed as dist

    from hydragnn_tpu_torch.device import resolve_device
    from hydragnn_tpu_torch.parallel import runtime

    if args.rank is not None:
        world = per_node = args.ranks
        local = args.rank
    else:
        world = int(os.environ.get("WORLD_SIZE", 1))
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local = runtime.local_rank()
    dev, backend = resolve_device(args.device), "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= per_node else "gloo"
        if dev.index is None:
            dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    if args.rank is not None:
        dist.init_process_group(backend, store=dist.FileStore(args.store, world),
                                rank=args.rank, world_size=world)
    elif not runtime.maybe_initialize_distributed(backend):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev, backend


def rank_arguments(ap: argparse.ArgumentParser) -> None:
    """``--ranks`` (the processes a driver started alone spawns; default
    one per branch) and the hidden ``--rank``/``--store`` a spawned rank
    is given."""
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes to start when run alone (not under torchrun; default: "
                    "one per branch; 1 runs in this process)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)


def write_rank_output(args, out: dict) -> None:
    """A spawned rank's report, beside its FileStore, where ``spawn``
    collects it."""
    if args.store is None:
        return
    import torch.distributed as dist

    path = os.path.join(os.path.dirname(args.store), f"rank{dist.get_rank()}.json")
    with open(path, "w") as f:
        json.dump(out, f)


def spawn(module: str, argv: Sequence[str], ranks: int) -> Tuple[int, List[Optional[dict]]]:
    """Start ``ranks`` processes of ``python -m <module>`` on ``argv``,
    joined through a FileStore in a fresh directory; when one fails the
    rest are stopped. Returns the first nonzero exit code (else 0) and
    each rank's report (``write_rank_output``; None where it wrote
    none)."""
    work = tempfile.mkdtemp(prefix=module.rsplit(".", 1)[-1] + "_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv, "--rank", str(r),
                               "--store", os.path.join(work, "store")], env=env)
             for r in range(ranks)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        outs = []
        for r in range(ranks):
            path = os.path.join(work, f"rank{r}.json")
            outs.append(json.load(open(path)) if os.path.exists(path) else None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)
    return next((p.returncode for p in procs if p.returncode != 0), 0), outs


def spawn_ranks(module: str, argv: Sequence[str], ranks: int, args) -> List[dict]:
    """``spawn`` of ``ranks`` ranks (after refusing ``cuda`` without a
    card here); raises unless every rank exited 0 with its report."""
    device(args)
    rc, outs = spawn(module, list(argv) + ["--ranks", str(ranks)], ranks)
    if rc != 0 or any(o is None for o in outs):
        raise RuntimeError(f"{module}: a rank exited with code {rc}")
    return outs
