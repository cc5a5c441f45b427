"""Scaffolding of the invariant (batch-normed) stacks.

Counterpart of ``_InvariantStack`` in ``hydragnn_tpu/models/invariant.py``:
a stack whose convs read only the node features and the batch, with
``norm_kind = "batch"`` so the multihead core puts a ``MaskedBatchNorm``
after every conv layer. PNA and PNAPlus (``models/pna.py``) build on it;
GIN, SAGE, MFC, CGCNN and GAT come with their slice (ROADMAP Queue 1
item 8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from hydragnn_tpu_torch.models.spec import ModelConfig


class _InvariantStack(nn.Module):
    """Convs ``conv_{i}`` called as ``conv(inv, batch)``; positions pass
    through unchanged."""

    norm_kind = "batch"

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def conv_in_dim(self, i: int) -> int:
        """Layer ``i``'s input width: the GPS embedding's hidden width, or
        the node features' at layer 0 without GPS."""
        cfg = self.cfg
        return cfg.hidden_dim if i > 0 or cfg.use_global_attn else cfg.input_dim

    def embed(self, batch) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
        return batch.x, batch.pos, {}

    def conv(self, i, inv, equiv, batch, extras):
        return getattr(self, f"conv_{i}")(inv, batch), equiv
