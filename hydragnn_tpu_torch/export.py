"""The inference forward shared by every deployment path.

Counterpart of ``hydragnn_tpu/export.py::make_forward``: eval mode, no
gradients, the raw tuple of head outputs. The port's model carries its
weights, so there is no ``variables`` argument. Export to a file
(``export_inference``/``load_exported``) and the ``with_forces`` form
(energies and forces from ``train/mlip.energy_and_forces``) come with
the export and serving item (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

from typing import Callable

import torch

from hydragnn_tpu_torch.models.spec import ModelConfig


def make_forward(model, cfg: ModelConfig, *, with_forces: bool = False) -> Callable:
    """``fn(batch) -> tuple of head outputs``, in eval mode under
    ``torch.no_grad()``."""
    del cfg
    if with_forces:
        raise NotImplementedError(
            "with_forces (energies + forces) is not ported to the served "
            "forward yet: ROADMAP Queue 1 item 14"
        )
    model.eval()

    def forward(batch):
        with torch.no_grad():
            return tuple(model(batch))

    return forward
