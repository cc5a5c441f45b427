"""Multibranch GFM training on the raw step API.

Counterpart of ``examples/multibranch/train.py``: several data sets train
one shared SchNet encoder with a decoder branch each, over ranks split
between the branches in proportion to the sets' sizes
(``proportional_branch_split``): encoder gradients averaged over every
rank, a branch's decoder gradients over its own ranks
(``make_multibranch_train_step``). The model is a ``ModelConfig`` built
directly (``--hidden_dim`` wide, 3 layers, radius 2.5, 16 Gaussians, one
graph head on default ``BranchSpec``s), the optimizer the dual AdamW
(``dual_optimizer``), and with ``--nosync K`` (K > 1) it accumulates
gradients over K steps between updates (``accumulate``). Each branch's
molecules come from ``make_branch_dataset`` (seed = branch index).

Alone it starts ``--ranks`` processes of itself (default: one per
branch), joined through a FileStore; under ``torchrun`` it joins the
group it finds; with ``--ranks 1`` it runs in this process. On one card
the ranks share it over gloo (NCCL refuses two ranks on one device), so
the steps run eagerly (gloo's collectives cannot be captured). Rank 0
prints the reference's lines; every rank reports its per-epoch losses,
a digest of its parameters after each step and epoch, and on the card
its K1/K2 launches, which ``main`` collects and returns.

    python -m hydragnn_tpu_torch.drivers.multibranch --epochs 10
    python -m hydragnn_tpu_torch.drivers.multibranch --device cpu --ranks 2 \\
        --sizes 24 12 --hidden_dim 8 --epochs 1 --nosync 2
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np

from hydragnn_tpu_torch.drivers import common

MODULE = "hydragnn_tpu_torch.drivers.multibranch"


def make_branch_dataset(n, scale, seed):
    """``n`` molecules of 6-15 atoms in a 3 A box, edges within 2.5 A (16
    nearest), one normal node feature, the target ``scale`` x its mean."""
    from hydragnn_tpu_torch.data.graph import GraphSample
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(6, 16))
        pos = rng.uniform(0, 3.0, (k, 3)).astype(np.float32)
        x = rng.normal(size=(k, 1)).astype(np.float32)
        y = scale * float(x.mean())
        out.append(GraphSample(x=x, pos=pos, edge_index=radius_graph(pos, 2.5, max_neighbours=16),
                               y_graph=np.array([y], np.float32)))
    return out


def branch_sets(sizes):
    """One set a branch: ``make_branch_dataset(n, 1 + b, seed=b)``."""
    return [make_branch_dataset(n, 1.0 + bi, seed=bi) for bi, n in enumerate(sizes)]


def model_config(hidden_dim: int, n_branches: int):
    """The reference's ``ModelConfig``."""
    from hydragnn_tpu_torch.models.spec import BranchSpec, HeadSpec, ModelConfig

    return ModelConfig(
        mpnn_type="SchNet", input_dim=1, hidden_dim=hidden_dim, num_conv_layers=3,
        heads=(HeadSpec("y", "graph", 1),),
        graph_branches=tuple(BranchSpec(name=f"branch-{i}") for i in range(n_branches)),
        node_branches=(), task_weights=(1.0,), radius=2.5, num_gaussians=16,
        num_filters=hidden_dim)


def parameter_digest(model) -> str:
    """sha256 of every parameter's bytes, in order."""
    import torch

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def launch_counts():
    """(K1, K2) launches so far in this process."""
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    return edge_pipeline_planned.launches, edge_pipeline_bwd_planned.launches


def _parser():
    ap = common.parser(__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--hidden_dim", type=int, default=32)
    ap.add_argument("--sizes", type=int, nargs="+", default=[300, 120, 80])
    ap.add_argument("--nosync", type=int, default=0, metavar="K",
                    help="accumulate gradients for K steps between syncs")
    common.rank_arguments(ap)
    return ap


def run_rank(args, joined: bool) -> dict:
    """The reference's training on this rank (every rank alike; rank 0
    prints). ``joined``: this process is a rank of a group (else it runs
    alone)."""
    import torch
    import torch.distributed as dist

    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.dp import replicate_state
    from hydragnn_tpu_torch.parallel.mesh import DataMesh
    from hydragnn_tpu_torch.parallel.multibranch import (
        MultiBranchLoader,
        accumulate,
        dual_optimizer,
        make_multibranch_train_step,
        proportional_branch_split,
    )
    from hydragnn_tpu_torch.parallel.runtime import ParallelPlan
    from hydragnn_tpu_torch.train.state import TrainState

    dev, backend = common.join(args) if joined else (common.device(args), None)
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    sets = branch_sets(args.sizes)
    dpb = proportional_branch_split(args.sizes, world)
    say(f"devices per branch: {dpb} (datasets {args.sizes})")
    cfg = model_config(args.hidden_dim, len(args.sizes))
    plan = ParallelPlan(scheme="multibranch", mesh=DataMesh(data=world),
                        devices_per_branch=tuple(dpb))
    model = replicate_state(create_model(cfg, dev, seed=0), plan, dev)
    loader = MultiBranchLoader(sets, dpb, args.batch_size, rank, seed=0)
    tx = dual_optimizer(model, {"Optimizer": {"type": "AdamW", "learning_rate": 2e-3}})
    if args.nosync > 1:
        tx = accumulate(tx, args.nosync)
    state = TrainState(model, tx)
    step = make_multibranch_train_step(model, tx, cfg, plan, dpb)

    out = {"rank": rank, "world": world, "backend": backend, "device": str(dev),
           "devices_per_branch": dpb, "epoch_loss": [], "epoch_digests": [],
           "step_digests": [parameter_digest(model)]}
    k0 = launch_counts()
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        tot, n = 0.0, 0
        for batch in loader:
            state, loss, _ = step(state, batch.to(dev))
            tot += float(loss)
            n += 1
            out["step_digests"].append(parameter_digest(model))
        out["epoch_loss"].append(tot / max(n, 1))
        out["epoch_digests"].append(out["step_digests"][-1])
        say(f"epoch {epoch:3d} | loss {tot / max(n, 1):.6f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        k1, k2 = (c - b for c, b in zip(launch_counts(), k0))
        out["calls"] = [{"call": "train_loop", "k1": k1, "k2": k2, "forwards": state.step,
                         "train_steps": state.step, "mpnn_type": cfg.mpnn_type,
                         "num_conv_layers": cfg.num_conv_layers, "potential": False}]
    out["seconds"] = time.perf_counter() - t0
    if joined:
        common.write_rank_output(args, out)
        dist.destroy_process_group()
    return out


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.rank is not None or common.launched():
        return run_rank(args, joined=True)
    ranks = len(args.sizes) if args.ranks is None else args.ranks
    outs = ([run_rank(args, joined=False)] if ranks == 1
            else common.spawn_ranks(MODULE, argv, ranks, args))
    return {"ranks": outs, "epoch_loss": outs[0]["epoch_loss"]}


if __name__ == "__main__":
    main()
