"""Structure relaxation with a trained potential: descent on the positions.

Counterpart of ``examples/multidataset_hpo_sc26/structure_optimization.py``:
train a quick PaiNN energy + force potential (``sc26_hpo.base_config``
with ``PAINN``: hidden 16, 2 layers) on molecular frames, then relax a
training geometry perturbed by normal draws of scale 0.25 (a generator of
seed 7) by gradient descent on the positions, ``p <- p - lr dE/dp``.
Each block rebuilds the radius graph (4 A, 24 neighbours) on the host and
collates the one sample, padded to its own size; a block's steps then run
on that fixed graph (``relax``). The run fails if the last energy is not
below the first.

On the card each batch carries the block plan, so a step's forward runs
K1 and the gradient with respect to the positions runs K2. A block's
first step runs eagerly (on the side stream, as every first sight of a
shape does), the step is then captured as a CUDA graph and replayed for
the block's other steps, with no host sync inside the block; the graph is
released when the block ends.

    python -m hydragnn_tpu_torch.drivers.structure_optimization
    python -m hydragnn_tpu_torch.drivers.structure_optimization --device cpu --epochs 1 \\
        --frames 20 --blocks 2 --steps 5
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from hydragnn_tpu_torch.drivers import common

RADIUS, MAX_NEIGHBOURS = 4.0, 24  # the blocks' radius graph


def block_sample(sample, pos):
    """``sample`` at ``pos`` (f32) with its radius graph rebuilt."""
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    return dataclasses.replace(sample, pos=pos.astype(np.float32),
                               edge_index=radius_graph(pos, RADIUS, max_neighbours=MAX_NEIGHBOURS))


def model_energy(model, batch, p):
    """Graph head 0 summed over the real graphs, with the first
    ``len(p)`` positions taken from ``p``."""
    import torch

    pos = torch.cat([p, batch.pos[p.shape[0]:]])
    out = model(dataclasses.replace(batch, pos=pos))[0][:, 0]
    return torch.where(batch.graph_mask, out, torch.zeros_like(out)).sum()


def descent_step(model, batch, p, lr: float) -> None:
    """One step ``p <- p - lr dE/dp``, in place."""
    import torch

    q = p.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(model_energy(model, batch, q), q)
    p.sub_(lr * g)


def relax(model, cfg, sample, pos0, *, blocks: int, steps: int, lr: float, device=None,
          capture: Optional[bool] = None) -> dict:
    """Relax ``sample`` from ``pos0`` by ``blocks`` blocks of ``steps``
    descent steps of rate ``lr`` under ``model`` (evaluated in eval
    mode; ``cfg`` its spec, as ``run_simulation`` takes the model's), the
    graph rebuilt every block and the one-sample batch padded
    to its own size with the block plan (module docstring). ``capture``
    (default: on a card) replays each block's steps as a captured step;
    without, every step runs eagerly. Returns
    ``energies`` (before the first block, after each block and at the
    end: blocks + 2 evaluations), the final positions ``pos`` [n, 3] f32,
    and the block loop's counts: eager steps, captures, replays and the
    captures' seconds."""
    import torch

    from hydragnn_tpu_torch.data.graph import PadSpec, collate
    from hydragnn_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    capture = dev.type == "cuda" if capture is None else capture
    stats = {"eager_steps": 0, "captures": 0, "replays": 0, "capture_seconds": 0.0}
    pos = np.asarray(pos0, np.float32).copy()
    energies = []
    was = model.training
    model.train(False)
    try:
        for _ in range(blocks):
            moved = block_sample(sample, pos)
            batch = collate([moved], PadSpec.for_samples([moved]),
                            with_segment_plan=True).to(dev)
            p = torch.as_tensor(pos, device=dev).clone()
            with torch.no_grad():
                if not energies:
                    energies.append(model_energy(model, batch, p))
                if capture and steps > 1:
                    _captured_block(model, batch, p, steps, lr, dev, stats)
                else:
                    for _ in range(steps):
                        descent_step(model, batch, p, lr)
                    stats["eager_steps"] += steps
                energies.append(model_energy(model, batch, p))
            pos = p.cpu().numpy()
        with torch.no_grad():
            energies.append(model_energy(model, batch, p))
    finally:
        model.train(was)
    return {"energies": [float(e) for e in energies], "pos": pos, **stats}


def _captured_block(model, batch, p, steps, lr, dev, stats) -> None:
    """A block on the card: the first step eager on the side stream, the
    step captured, replayed ``steps - 1`` times (each replay adding the
    launches the capture recorded), then the graph released."""
    import torch

    from hydragnn_tpu_torch.train.capture import (
        GRAPH_LOCK,
        _launch_counters,
        collector_paused,
        side_stream,
    )

    with GRAPH_LOCK:
        side, cur = side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            descent_step(model, batch, p, lr)
        cur.wait_stream(side)
        stats["eager_steps"] += 1
        t0 = time.perf_counter()
        counters = _launch_counters()
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), torch.cuda.graph(graph):
            descent_step(model, batch, p, lr)
        recorded = [c.launches - b for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.launches = b
        torch.cuda.synchronize(dev)
        stats["capture_seconds"] += time.perf_counter() - t0
        stats["captures"] += 1
        for _ in range(steps - 1):
            graph.replay()
            for c, n in zip(counters, recorded):
                c.launches += n
        stats["replays"] += steps - 1
        torch.cuda.synchronize(dev)
        graph.reset()


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--blocks", type=int, default=5,
                    help="outer blocks (neighbor-graph rebuilds)")
    ap.add_argument("--steps", type=int, default=40, help="descent steps per block")
    ap.add_argument("--lr", type=float, default=2e-3)
    args = ap.parse_args(argv)
    dev = common.device(args)

    from hydragnn_tpu_torch.drivers.molecules import random_molecule_frames
    from hydragnn_tpu_torch.drivers.sc26_hpo import base_config

    config = base_config(args.epochs, 8)
    config["NeuralNetwork"]["Architecture"]["mpnn_type"] = "PAINN"
    frames = random_molecule_frames(args.frames, seed=0)
    _, model, cfg, hist, _ = common.train(config, common.split(frames), dev)
    print(f"potential trained: val {hist.val_loss[-1]:.5f}")

    # a training-pool geometry, strongly perturbed
    rng = np.random.default_rng(7)
    sample = frames[0]
    pos0 = sample.pos + rng.normal(scale=0.25, size=sample.pos.shape).astype(np.float32)
    res = relax(model, cfg, sample, pos0, blocks=args.blocks, steps=args.steps, lr=args.lr,
                device=dev)
    energies = res["energies"]
    for block, e in enumerate(energies[1:-1]):
        print(f"block {block}: E = {e:.5f}")
    print(f"relaxed: E {energies[0]:.5f} -> {energies[-1]:.5f}")
    if not energies[-1] < energies[0]:
        raise RuntimeError(f"relaxation must lower the model energy: {energies}")
    return {"val_loss": float(hist.val_loss[-1]), "energies": energies,
            "e_first": energies[0], "e_last": energies[-1],
            **{k: res[k] for k in ("eager_steps", "captures", "replays", "capture_seconds")}}


if __name__ == "__main__":
    main()
