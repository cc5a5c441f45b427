"""MD rollout state: the carry of the K-step macro.

Counterpart of ``hydragnn_tpu/simulate/state.py``: ``MDState``,
``md_template_batch``, ``maxwell_boltzmann_velocities``,
``kinetic_energy`` and ``total_momentum``, plus ``md_state_from_numpy``,
which carries a JAX ``MDState`` across as numpy leaves (as
``models/convert.params_from_jax`` carries parameters).

``MDState`` is the complete dynamical state of a rollout, with the JAX
package's leaves, names and types: positions, velocities, the cached
forces and energy at those positions, the cached fixed-capacity neighbor
list with its skin reference positions, the thermostat key (``ops/prng``:
int64 ``[2]`` holding the two uint32 words) and the containment ledger.
It holds no block plan: the force pass derives the plan from
``receivers`` each step, so a checkpoint keeps the JAX layout. On the
card the engine keeps one ``MDState`` of static device tensors that its
captured macros update in place (``simulate/engine.py``); the states it
hands out are copies.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hydragnn_tpu_torch.data.graph import GraphBatch
from hydragnn_tpu_torch.ops import prng

__all__ = [
    "MDState",
    "md_template_batch",
    "md_state_from_numpy",
    "maxwell_boltzmann_velocities",
    "kinetic_energy",
    "total_momentum",
]


@dataclasses.dataclass
class MDState:
    """The rollout carry. N = padded node count (the real atoms and at
    least one masked padding node, the last, on which the list parks
    empty edge slots), E = the neighbor list's slots."""

    # dynamical state (committed by select-not-add containment)
    pos: torch.Tensor  # [N, 3] positions; padding rows frozen at 0
    vel: torch.Tensor  # [N, 3] velocities; padding rows stay 0
    forces: torch.Tensor  # [N, 3] forces at ``pos``
    energy: torch.Tensor  # [] potential energy at ``pos``

    # cached neighbor list, built at cutoff + skin, receiver-sorted
    senders: torch.Tensor  # [E] int32
    receivers: torch.Tensor  # [E] int32
    edge_mask: torch.Tensor  # [E] bool
    ref_pos: torch.Tensor  # [N, 3] positions at the last rebuild

    # thermostat key, frozen on uncommitted steps
    key: torch.Tensor  # [2] int64 (two uint32 words)

    # counters and the containment ledger
    step: torch.Tensor  # [] int32, ticks on every step, committed or not
    good_steps: torch.Tensor  # [] int32, committed steps
    rebuilds: torch.Tensor  # [] int32, committed neighbor rebuilds
    overflow: torch.Tensor  # [] int32, high-water neighbor overflow
    poisoned: torch.Tensor  # [] bool, sticky within a macro

    def leaves(self) -> dict:
        """Every leaf by name, in the JAX package's order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "MDState":
        """A copy of every leaf (the engine's static carry stays its own)."""
        return MDState(**{k: v.clone() for k, v in self.leaves().items()})

    def copy_(self, other: "MDState") -> None:
        """Write ``other``'s leaves into this state's tensors in place."""
        for k, v in self.leaves().items():
            v.copy_(getattr(other, k))


def md_state_from_numpy(state, device=None) -> MDState:
    """An ``MDState`` on ``device`` from a JAX ``MDState`` whose leaves
    are numpy arrays (``jax.device_get(state)``). The uint32 key words
    become int64; every other leaf keeps its type."""
    out = {}
    for f in dataclasses.fields(MDState):
        a = np.asarray(getattr(state, f.name))
        if f.name == "key":
            a = a.astype(np.int64)
        out[f.name] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return MDState(**out)


def md_template_batch(
    x: np.ndarray,
    pos: np.ndarray,
    max_edges: int,
    *,
    n_pad_nodes: int = 1,
    dtype=np.float32,
) -> GraphBatch:
    """The rollout's static single-graph batch, the JAX package's
    template: one real graph (slot 0) and one padding graph (slot 1)
    holding the ``n_pad_nodes`` padding rows; edge arrays at the neighbor
    capacity, every slot parked on the last (padding) node with a False
    mask, as ``collate`` parks padding edges; CPU tensors (the engine
    moves them to its device). It carries no block plan (the engine plans
    each step's list on the device)."""
    if n_pad_nodes < 1:
        raise ValueError("md_template_batch needs >= 1 padding node slot")
    n_real = int(pos.shape[0])
    n = n_real + int(n_pad_nodes)
    f_dim = x.shape[1] if x.ndim > 1 else 1
    xp = np.zeros((n, f_dim), dtype=dtype)
    xp[:n_real] = np.asarray(x, dtype=dtype).reshape(n_real, f_dim)
    posp = np.zeros((n, 3), dtype=dtype)
    posp[:n_real] = np.asarray(pos, dtype=dtype)
    node_graph_idx = np.full((n,), 1, dtype=np.int32)
    node_graph_idx[:n_real] = 0
    node_slot = np.zeros((n,), dtype=np.int32)
    node_slot[:n_real] = np.arange(n_real, dtype=np.int32)
    node_mask = np.zeros((n,), dtype=bool)
    node_mask[:n_real] = True
    pad_node = n - 1
    batch = GraphBatch(
        x=xp,
        pos=posp,
        node_graph_idx=node_graph_idx,
        node_slot=node_slot,
        node_mask=node_mask,
        senders=np.full((max_edges,), pad_node, dtype=np.int32),
        receivers=np.full((max_edges,), pad_node, dtype=np.int32),
        edge_mask=np.zeros((max_edges,), dtype=bool),
        graph_mask=np.array([True, False]),
    )
    return batch.to("cpu")


def maxwell_boltzmann_velocities(key, node_mask, masses, kt: float) -> torch.Tensor:
    """[N, 3] thermal velocities at temperature kT: per-component normal
    draws (``ops/prng.normal``) with std sqrt(kT/m), zero on padding rows,
    and the centre-of-mass drift removed."""
    n = node_mask.shape[0]
    vel = prng.normal(key, (n, 3))
    kt_t = torch.full((), float(kt), dtype=torch.float32, device=masses.device)
    vel = vel * torch.sqrt(kt_t / masses)
    mask = node_mask.to(vel.dtype)[:, None]
    vel = vel * mask
    m = masses * node_mask.to(masses.dtype)[:, None]
    total_m = torch.sum(m)
    drift = torch.sum(vel * m, dim=0) / torch.clamp(total_m, min=1e-12)
    return (vel - drift[None, :]) * mask


def kinetic_energy(vel, masses, node_mask) -> torch.Tensor:
    """Scalar kinetic energy over the real atoms."""
    m = masses * node_mask.to(masses.dtype)[:, None]
    return 0.5 * torch.sum(m * vel * vel)


def total_momentum(vel, masses, node_mask) -> torch.Tensor:
    """[3] total momentum over the real atoms."""
    m = masses * node_mask.to(masses.dtype)[:, None]
    return torch.sum(m * vel, dim=0)
