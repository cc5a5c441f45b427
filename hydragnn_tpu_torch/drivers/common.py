"""What the example drivers share: their configs' paths and the
``--config``/``--device`` arguments.

Each driver reads its JSON config from the repository's ``examples/``
tree by path (the reference scripts' own files, read and never copied or
edited; ``--config`` names another) and runs on the card unless
``--device`` names another device (``device.resolve_device``: ``cuda``
without a card raises). ``main(argv)`` of each driver returns what it
printed as numbers.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def example_path(*parts: str) -> str:
    """A file of the repository's ``examples/`` tree."""
    return os.path.join(REPO, "examples", *parts)


def parser(description: str, config: Optional[Sequence[str]] = None) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` and, where the driver reads
    one, ``--config`` defaulting to ``examples/<config...>``."""
    ap = argparse.ArgumentParser(description=description)
    if config is not None:
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
