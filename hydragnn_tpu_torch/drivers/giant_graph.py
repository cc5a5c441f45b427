"""Giant-graph training: ONE structure too large for a card, sharded over
ranks, trained end to end with ring attention.

Counterpart of ``examples/giant_graph/giant.py``. Node and edge arrays
of a single big structure are sharded over a ``graph`` mesh axis of D
ranks (``parallel/graphshard``); message passing runs through all-gather
/ reduce-scatter collectives, or with ``--halo`` through halo exchange
of boundary rows, and global attention through ring attention. Each
train step is the loss, its gradients (summed over the ranks) and an
Adam update, every rank holding the same parameters.

Data: thermal configurations of one Morse-potential solid; the model
fits the total energy. Configurations share one set of shapes through a
fixed edge capacity (all-gather) or a union halo layout (``--halo``).

    python -m hydragnn_tpu_torch.drivers.giant_graph --ranks 2 --device cpu \\
        --atoms 125 --configs 6 --epochs 2 --halo

Alone it starts ``--ranks`` processes of itself, joined through a
FileStore; under ``torchrun`` it joins the group it finds (one rank per
process). On cards the ranks take ``cuda:LOCAL_RANK`` modulo the visible
cards: NCCL with a card per rank, else gloo (ranks sharing a card, where
NCCL refuses two ranks on one device). Steps run eagerly: gloo's
collectives cannot be captured in a CUDA graph, and a captured
graph-sharded step under NCCL waits for a host with two or more cards.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.drivers import common

MORSE_D, MORSE_A, MORSE_R0 = 0.4, 1.1, 2.2
NUM_GAUSSIANS = 16
NUM_LAYERS = 2
LEARNING_RATE = 3e-3


def _morse_energy(pos: np.ndarray, block: int = 512) -> float:
    """giant.py's pairwise Morse energy, summed over row blocks of
    ``block`` atoms so the host holds ``[block, N, 3]``, not ``[N, N, 3]``
    (1.5 GB at 8,000 atoms)."""
    pos = np.asarray(pos, np.float64)
    total = 0.0
    for i in range(0, pos.shape[0], block):
        diff = pos[i: i + block, None, :] - pos[None, :, :]
        d = np.linalg.norm(diff, axis=-1)
        rows = np.arange(d.shape[0])
        d[rows, rows + i] = np.inf
        ex = np.exp(-MORSE_A * (d - MORSE_R0))
        total += float((MORSE_D * (1.0 - ex) ** 2).sum())
    return total / 2.0


def build_configs(n_atoms: int, n_configs: int, cutoff: float, seed: int = 0):
    """Thermal snapshots of one big fcc-ish solid + Morse energies:
    ``([(pos f32 [N, 3], edge_index [2, E], energy)], edge_capacity)``."""
    from hydragnn_tpu_torch.ops.neighbors import radius_graph

    rng = np.random.default_rng(seed)
    side = int(round(n_atoms ** (1 / 3)))
    grid = np.stack(
        np.meshgrid(*([np.arange(side) * 2.4] * 3), indexing="ij"), axis=-1
    ).reshape(-1, 3)[:n_atoms]
    configs = []
    for _ in range(n_configs):
        pos = grid + rng.normal(scale=0.08, size=grid.shape)
        ei = radius_graph(pos, cutoff, max_neighbours=20)
        configs.append((pos.astype(np.float32), ei, _morse_energy(pos)))
    edge_cap = max(c[1].shape[1] for c in configs)
    return configs, edge_cap


def z_sorted(pos: np.ndarray, ei: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Atoms sorted along z, so shard boundaries are thin shells (the
    ordering is what makes the halo small); the edge list is remapped,
    not rebuilt."""
    order = np.argsort(pos[:, 2])
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return pos[order], inv[ei]


def shard_configs(configs, edge_cap: int, n_shards: int, *, halo: bool) -> list:
    """giant.py's host shards, one per configuration: with ``halo`` the
    z-sorted structure probed, the union layout taken and every
    configuration rebuilt on it (two passes); else ``GraphShards`` at the
    fixed ``edge_cap``. Node features are the constant species channel."""
    from hydragnn_tpu_torch.parallel.graphshard import GraphShards, HaloShards

    x0 = np.ones((configs[0][0].shape[0], 1), np.float32)
    if halo:
        sorted_cfgs = [z_sorted(pos, ei) for pos, ei, _ in configs]
        probes = [HaloShards.build(x0, pos, ei, n_shards) for pos, ei in sorted_cfgs]
        layout = HaloShards.union_layout(probes)
        return [HaloShards.build(x0, pos, ei, n_shards, layout=layout)
                for pos, ei in sorted_cfgs]
    return [GraphShards.build(x0, pos, ei, n_shards, edge_capacity=edge_cap)
            for pos, ei, _ in configs]


def forward_for(halo: bool):
    """The scheme's sharded forward: halo exchange or all-gather."""
    from hydragnn_tpu_torch.parallel.graphshard import halo_mpnn_forward, sharded_mpnn_forward

    return halo_mpnn_forward if halo else sharded_mpnn_forward


def model_kwargs(args) -> dict:
    return dict(cutoff=args.cutoff, num_gaussians=NUM_GAUSSIANS, num_layers=NUM_LAYERS,
                attn_heads=args.attn_heads)


def standardized_loss(e, target: float, e_mean: float, e_std: float):
    """Standardized regression on the energy deviation from the data
    set's mean (thermal fluctuations are the learnable signal)."""
    return ((e - (target - e_mean)) / e_std) ** 2


def train_step(forward, params, optimizer, shards, mesh, target: float, e_mean: float,
               e_std: float, **model_kw):
    """One step on every rank: the replicated energy, the loss, its
    gradients summed over the ranks, the Adam update. Returns (loss,
    energy), detached."""
    from hydragnn_tpu_torch.parallel.graphshard import sum_gradients_

    optimizer.zero_grad()
    e = forward(params, shards, mesh, **model_kw)
    loss = standardized_loss(e, target, e_mean, e_std)
    loss.backward()
    sum_gradients_(params, mesh)
    optimizer.step()
    return loss.detach(), e.detach()


def make_optimizer(params):
    """The port's ``Adam`` at 3e-3 with ``optax.adam``'s defaults."""
    from hydragnn_tpu_torch.parallel.graphshard import param_leaves
    from hydragnn_tpu_torch.train.optimizer import Adam

    return Adam(param_leaves(params), LEARNING_RATE, betas=(0.9, 0.999), eps=1e-8)


def make_params(args, device):
    """``init_params`` from a generator seeded 0: 1 input channel,
    ``--hidden``, 2 layers, 16 Gaussians, ``--attn_heads``."""
    import torch

    from hydragnn_tpu_torch.parallel.graphshard import init_params

    return init_params(torch.Generator().manual_seed(0), 1, args.hidden, NUM_LAYERS,
                       NUM_GAUSSIANS, attn_heads=args.attn_heads, device=device)


def memory_model(h0, hidden: int, device) -> str:
    """The per-rank memory model of the halo scheme against the
    all-gather one, in feature rows; on a card, also the atoms its own
    memory admits (``torch.cuda.get_device_properties``)."""
    import torch

    frac = h0.halo_rows / h0.num_nodes_padded
    gather = (f"  all-gather: {h0.num_nodes_padded} rows — the FULL graph on every rank")
    halo = (f"  halo:       {h0.halo_rows} rows = {h0.n_loc} local + {sum(h0.caps)} boundary "
            f"({frac:.2f}x of N on this geometry)")
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        max_rows = props.total_memory / (hidden * 4)
        gather += (f"; {props.name}'s {props.total_memory / 2**30:.1f} GiB caps it at "
                   f"~{max_rows / 1e6:.0f}M atoms regardless of rank count")
        halo += (f"; the same memory admits ~{max_rows / frac / 1e6:.0f}M atoms on this "
                 "mesh, growing with rank count")
    return (f"memory model (per rank, per layer feature rows x {hidden} features x 4B):\n"
            f"{gather}\n{halo}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--atoms", type=int, default=512)
    ap.add_argument("--configs", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--attn_heads", type=int, default=2)
    ap.add_argument("--cutoff", type=float, default=3.2)
    ap.add_argument(
        "--halo", action="store_true",
        help="halo exchange instead of all-gather: per-rank memory is n_loc + boundary rows "
        "instead of the FULL node set (the path for graphs whose gathered features exceed "
        "one card's memory)")
    ap.add_argument("--ranks", type=int, default=2,
                    help="ranks of the graph axis when started alone (not under torchrun)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap


def run_rank(args) -> None:
    """giant.py's training on this rank (every rank alike; rank 0 prints)."""
    import torch
    import torch.distributed as dist

    from hydragnn_tpu_torch.parallel.mesh import make_mesh

    device, backend = common.join(args)
    mesh = make_mesh({"graph": dist.get_world_size()})
    say = print if mesh.index == 0 else (lambda *a, **k: None)
    eager = "" if device.type != "cuda" else "; steps eager: " + (
        "gloo's collectives cannot be captured in a CUDA graph" if backend == "gloo" else
        "a captured graph-sharded step under NCCL waits for a host with two or more cards")
    say(f"{args.atoms}-atom structure sharded over {mesh.size} ranks ({backend} on "
        f"{device}{eager})")
    configs, edge_cap = build_configs(args.atoms, args.configs, args.cutoff, seed=0)
    energies = np.array([c[2] for c in configs], np.float32)
    e_mean, e_std = float(energies.mean()), float(energies.std() + 1e-6)
    host = shard_configs(configs, edge_cap, mesh.size, halo=args.halo)
    if args.halo:
        say(memory_model(host[0], args.hidden, device))
    shard_list = [h.local(mesh, device) for h in host]
    params = make_params(args, device)
    opt = make_optimizer(params)
    fwd = forward_for(args.halo)
    kw = model_kwargs(args)

    n_train = int(0.8 * len(configs))
    for epoch in range(args.epochs):
        tot = 0.0
        for i in range(n_train):
            loss, _ = train_step(fwd, params, opt, shard_list[i], mesh, configs[i][2], e_mean,
                                 e_std, **kw)
            tot += float(loss)
        val = 0.0
        with torch.no_grad():
            for i in range(n_train, len(configs)):
                e = fwd(params, shard_list[i], mesh, **kw)
                val += float(standardized_loss(e, configs[i][2], e_mean, e_std))
        say(f"epoch {epoch:3d} | train {tot / n_train:.5f} "
            f"| val {val / max(len(configs) - n_train, 1):.5f}")
    say("giant-graph training done")
    dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    if args.rank is not None or common.launched():
        run_rank(args)
        return 0
    return common.spawn("hydragnn_tpu_torch.drivers.giant_graph", argv, args.ranks)[0]


if __name__ == "__main__":
    sys.exit(main())
