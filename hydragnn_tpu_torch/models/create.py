"""Model factory.

Counterpart of ``hydragnn_tpu/models/create.py``: maps ``mpnn_type`` to
a stack class and wraps it in the multihead core (``create_model``), and
builds both from a full config (``create_model_config``). The port's
model carries its parameters, so creation also initializes them (the
JAX package's ``init_params``). All thirteen of the JAX package's stacks
are registered: SchNet, PAINN, PNAEq, EGNN, MACE, DimeNet, the invariant
stacks (GIN, SAGE, MFC, CGCNN, GAT) and PNA/PNAPlus. ``needs_triplets``
names the stacks whose batches carry angular triplets (DimeNet).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Type, Union

import torch
from torch import nn

from hydragnn_tpu_torch.device import resolve_device
from hydragnn_tpu_torch.models.base import MultiHeadGraphModel
from hydragnn_tpu_torch.models.dimenet import DIMEStack
from hydragnn_tpu_torch.models.equivariant import EGCLStack, PAINNStack, PNAEqStack
from hydragnn_tpu_torch.models.invariant import (
    CGCNNStack,
    GATStack,
    GINStack,
    MFCStack,
    SAGEStack,
)
from hydragnn_tpu_torch.models.layers import init_flax_
from hydragnn_tpu_torch.models.mace import MACEStack
from hydragnn_tpu_torch.models.pna import PNAPlusStack, PNAStack
from hydragnn_tpu_torch.models.schnet import SchNetStack
from hydragnn_tpu_torch.models.spec import ModelConfig, model_config_from_dict

STACKS: Dict[str, Type[nn.Module]] = {
    "SchNet": SchNetStack,
    "GIN": GINStack,
    "SAGE": SAGEStack,
    "MFC": MFCStack,
    "CGCNN": CGCNNStack,
    "GAT": GATStack,
    "EGNN": EGCLStack,
    "PAINN": PAINNStack,
    "MACE": MACEStack,
    "PNA": PNAStack,
    "PNAPlus": PNAPlusStack,
    "PNAEq": PNAEqStack,
    "DimeNet": DIMEStack,
}

#: mpnn types whose batches must carry host-built angular triplets.
NEEDS_TRIPLETS = frozenset({"DimeNet"})


def needs_triplets(mpnn_type: str) -> bool:
    return mpnn_type in NEEDS_TRIPLETS


def create_model(
    cfg: ModelConfig,
    device: Optional[Union[str, torch.device]] = None,
    *,
    seed: int = 0,
) -> MultiHeadGraphModel:
    """Build the model, initialize it with flax's initializers from a
    ``torch.Generator`` seeded with ``seed``, and move it to ``device``
    (``None`` means ``"cuda"``, which raises without a card)."""
    dev = resolve_device(device)
    if cfg.mpnn_type not in STACKS:
        raise ValueError(
            f"Unknown mpnn_type {cfg.mpnn_type!r}; available in the port: "
            f"{sorted(STACKS)}"
        )
    model = MultiHeadGraphModel(cfg, STACKS[cfg.mpnn_type])
    init_flax_(model, seed)
    return model.to(dev)


def create_model_config(
    config: dict,
    device: Optional[Union[str, torch.device]] = None,
    *,
    seed: int = 0,
) -> Tuple[MultiHeadGraphModel, ModelConfig]:
    """The model (initialized from ``seed``, on ``device``) and its spec
    from a full (post-``update_config``) JSON config."""
    cfg = model_config_from_dict(config)
    return create_model(cfg, device, seed=seed), cfg
