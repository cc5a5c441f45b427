"""Open Polymers 2026: a graph property and a conv-decoded node property.

Counterpart of ``examples/open_polymers_2026/train.py``: polymers.json's
SAGE (hidden 64, 3 layers) with a graph head for a glass-transition-like
chain score and a CONV node head ([64, 64] + 1; K1/K2 a,W on the card)
for a per-site strain proxy, trained on synthetic homopolymer chains
(backbones of 20-39 sites with side groups of 1-2 atoms; seed 26, the
reference's draws in its order).

    python -m hydragnn_tpu_torch.drivers.polymers --epochs 10
    python -m hydragnn_tpu_torch.drivers.polymers --device cpu --chains 40 --epochs 1
"""

from __future__ import annotations

import numpy as np

from hydragnn_tpu_torch.drivers import common

MONOMERS = 3  # one-hot monomer types


def polymer_chain(rng):
    """One chain from ``rng``: a backbone of 20-39 sites with side groups
    of 1-2 atoms on about half of them, one-hot monomer types, a graph
    target from length, branching and composition, and a per-node strain
    proxy (degree times the mean neighbor-type difference)."""
    from hydragnn_tpu_torch.data.graph import GraphSample

    n_backbone = int(rng.integers(20, 40))
    edges = [(i, i + 1) for i in range(n_backbone - 1)]
    types = [int(rng.integers(0, MONOMERS)) for _ in range(n_backbone)]
    n = n_backbone
    for i in range(n_backbone):
        if rng.random() < 0.5:
            k = int(rng.integers(1, 3))
            prev = i
            for _ in range(k):
                edges.append((prev, n))
                types.append(int(rng.integers(0, MONOMERS)))
                prev = n
                n += 1
    snd = np.array([e[0] for e in edges] + [e[1] for e in edges])
    rcv = np.array([e[1] for e in edges] + [e[0] for e in edges])
    t = np.asarray(types)
    x = np.zeros((n, MONOMERS), np.float32)
    x[np.arange(n), t] = 1.0
    deg = np.bincount(snd, minlength=n).astype(np.float32)
    branch_frac = float((deg > 2).mean())
    comp = x.mean(axis=0)
    y_graph = np.array([0.01 * n + 2.0 * branch_frac + float(comp @ [0.5, -0.3, 0.1])],
                       np.float32)
    ntype = t[rcv].astype(np.float32)
    nbr_mean = np.zeros(n, np.float32)
    np.add.at(nbr_mean, snd, ntype)
    nbr_mean /= np.maximum(deg, 1.0)
    y_node = (0.3 * deg + np.abs(t - nbr_mean)).astype(np.float32)
    return GraphSample(x=x, edge_index=np.stack([snd, rcv]).astype(np.int64), y_graph=y_graph,
                       y_node=y_node.reshape(-1, 1))


def polymer_chains(n_chains: int, seed: int = 26):
    """``n_chains`` chains from one generator of ``seed``."""
    rng = np.random.default_rng(seed)
    return [polymer_chain(rng) for _ in range(n_chains)]


def main(argv=None) -> dict:
    ap = common.parser(__doc__.splitlines()[0], ("open_polymers_2026", "polymers.json"))
    ap.add_argument("--chains", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args(argv)
    dev = common.device(args)

    config = common.example_config(args)
    hist = common.train(config, common.split(polymer_chains(args.chains)), dev)[3]
    out = common.final_losses(hist)
    tasks = np.asarray(hist.test_tasks[-1]).reshape(-1)
    print(f"per-task: glass_transition {tasks[0]:.5f} backbone_strain (conv head) "
          f"{tasks[1]:.5f}")
    out.update(glass_transition=float(tasks[0]), backbone_strain=float(tasks[1]))
    return out


if __name__ == "__main__":
    main()
