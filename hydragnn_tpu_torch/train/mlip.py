"""Interatomic-potential (MLIP) training: energies and their forces.

Counterpart of ``hydragnn_tpu/train/mlip.py``: the model predicts
per-node or per-graph energies, and the forces are the negative
gradient of the total energy with respect to the positions. Where the
JAX package nests ``jax.grad`` inside the loss, the port takes
``torch.autograd.grad(create_graph=True)``, so the loss's backward
differentiates the force pass a second time: every receiver aggregation
then runs K1 forward, K2 in the force pass and K1/K2 again in the loss's
backward (K2's operator in ``ops/edge_pipeline.py``).

Loss terms (weights ``Architecture.{energy,energy_peratom,force}_weight``):
  1. graph energy loss
  2. energy-per-atom loss (energy / number of real atoms)
  3. force loss on the per-atom force vectors
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops.segment import dense_segment_sum
from hydragnn_tpu_torch.train.losses import head_loss


def nodes_per_graph(batch, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[G] number of real nodes in each graph (a one-hot matmul: no
    float atomics, no host sync)."""
    return dense_segment_sum(
        batch.node_mask.to(dtype), batch.node_graph_idx, batch.num_graphs
    )


def predict_graph_energy(model, batch, cfg: ModelConfig) -> torch.Tensor:
    """[G] graph energies, zero on padding graphs. A node head sums its
    node energies per graph; a graph head needs sum pooling, so that
    dE/dpos splits into per-atom forces."""
    if len(cfg.heads) != 1:
        raise ValueError("Force predictions require exactly one head.")
    head = cfg.heads[0]
    if head.type not in ("node", "graph"):
        raise ValueError(
            "Force predictions are only supported for node or graph energy heads."
        )
    if head.type == "graph" and cfg.graph_pooling != "add":
        raise ValueError(
            "Graph head force loss requires sum pooling (graph_pooling='add')."
        )
    pred = model(batch)[0][:, : head.dim]
    if head.type == "node":
        node_e = pred[:, 0] * batch.node_mask.to(pred.dtype)
        graph_e = dense_segment_sum(
            node_e[:, None], batch.node_graph_idx, batch.num_graphs
        )[:, 0]
    else:
        graph_e = pred[:, 0]
    return graph_e * batch.graph_mask.to(graph_e.dtype)


def energy_and_forces(
    model, batch, cfg: ModelConfig, *, create_graph: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(graph energies [G], forces [N, 3]) with forces
    ``-d(sum_g E_g)/d pos * node_mask``: each atom moves only its own
    graph's energy, so the gradient of the sum is the per-atom force
    field. ``create_graph`` keeps the force pass differentiable (for
    training); an evaluation passes False and gets no graph back."""
    if batch.pos is None:
        raise ValueError("batch.pos must be provided for forces.")
    pos = batch.pos.detach().requires_grad_(True)
    graph_e = predict_graph_energy(model, dataclasses.replace(batch, pos=pos), cfg)
    (grad_pos,) = torch.autograd.grad(
        graph_e.sum(), pos, create_graph=create_graph
    )
    forces = -grad_pos * batch.node_mask.to(grad_pos.dtype)[:, None]
    return graph_e, forces


def energy_force_loss_terms(
    graph_e: torch.Tensor, forces: torch.Tensor, batch, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted total, per-task [energy, energy_peratom, force]). All
    three task losses are reported; the weights pick what the total
    holds."""
    kind = cfg.loss_function_type
    if kind == "GaussianNLLLoss":
        raise ValueError(
            "GaussianNLLLoss is not supported for interatomic potential "
            "training; use mse/mae/smooth_l1/rmse."
        )
    gmask = batch.graph_mask
    e_true = batch.energy * gmask.to(graph_e.dtype)
    e_loss = head_loss(kind, graph_e, e_true, gmask)
    natoms = torch.clamp(nodes_per_graph(batch, graph_e.dtype), min=1.0)
    epa_loss = head_loss(kind, graph_e / natoms, e_true / natoms, gmask)
    f_true = batch.forces * batch.node_mask.to(forces.dtype)[:, None]
    f_loss = head_loss(kind, forces, f_true, batch.node_mask)
    tot = (
        cfg.energy_weight * e_loss
        + cfg.energy_peratom_weight * epa_loss
        + cfg.force_weight * f_loss
    )
    return tot, torch.stack([e_loss, epa_loss, f_loss])


def energy_force_loss(
    model, batch, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted MLIP loss of a batch: (total, per-task), with the
    force pass kept differentiable for the loss's backward."""
    if cfg.energy_weight <= 0 and cfg.energy_peratom_weight <= 0 and cfg.force_weight <= 0:
        raise ValueError(
            "All interatomic potential loss weights are zero; set at "
            "least one of energy_weight, energy_peratom_weight, or "
            "force_weight to a positive value."
        )
    if batch.pos is None or batch.energy is None or batch.forces is None:
        raise ValueError(
            "batch.pos, batch.energy, batch.forces must be provided for "
            "energy-force loss."
        )
    graph_e, forces = energy_and_forces(model, batch, cfg)
    return energy_force_loss_terms(graph_e, forces, batch, cfg)
