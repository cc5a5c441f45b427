"""examples/open_polymers_2026's synthetic polymer chains as the port's
samples, for the port's tests (no JAX import).

``polymer_chain`` copies the example's recipe (train.py) in its order
of draws, so one seeded generator gives the same arrays as the
example's; ``polymer_splits`` makes its 300 chains (seed 26) and splits
them 0.8 with the port's ``split_dataset``, as its ``main()`` does.
"""

import json
import os

import numpy as np

MONOMERS = 3  # one-hot monomer types
CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples",
                      "open_polymers_2026", "polymers.json")


def polymer_chain(rng):
    """One homopolymer chain: a backbone of 20-39 sites with side groups
    of 1-2 atoms on about half of them; a graph target from length,
    branching and composition, and a per-node strain proxy."""
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
    y_graph = np.array(
        [0.01 * n + 2.0 * branch_frac + float(comp @ [0.5, -0.3, 0.1])], np.float32
    )
    ntype = t[rcv].astype(np.float32)
    nbr_mean = np.zeros(n, np.float32)
    np.add.at(nbr_mean, snd, ntype)
    nbr_mean /= np.maximum(deg, 1.0)
    y_node = (0.3 * deg + np.abs(t - nbr_mean)).astype(np.float32)
    return GraphSample(x=x, edge_index=np.stack([snd, rcv]).astype(np.int64),
                       y_graph=y_graph, y_node=y_node.reshape(-1, 1))


def polymer_splits(n_chains=300, seed=26):
    from hydragnn_tpu_torch.data.loader import split_dataset

    rng = np.random.default_rng(seed)
    return split_dataset([polymer_chain(rng) for _ in range(n_chains)], 0.8)


def polymer_config():
    with open(CONFIG) as f:
        return json.load(f)
