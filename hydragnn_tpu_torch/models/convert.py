"""Carry weights over from the JAX package.

No JAX counterpart. ``params_from_jax`` maps the JAX package's
``params`` tree — nested dicts of numpy arrays, as
``jax.device_get(state.params)`` gives them — onto the port's
``state_dict``, without importing JAX. The port names its submodules as
flax does, so a path ``stack/conv_0/filter_mlp/dense_1/kernel`` becomes
``stack.conv_0.filter_mlp.dense_1.weight``, and PaiNN's
``stack/message_0/filter_layer``, ``.../scalar_message_mlp/dense_{i}``,
``stack/update_0/update_U`` (no bias), ``.../update_mlp/dense_{i}``,
``stack/node_embed_out_0/dense_{i}`` and ``stack/vec_embed_out_0`` (no
bias) map the same way:

- a Dense ``kernel`` ``[in, out]`` becomes an ``nn.Linear`` ``weight``
  ``[out, in]`` (transposed);
- a ``DenseParams`` kernel (SchNet's ``conv_{i}/lin2`` and a conv node
  head's ``neigh_{i}``: the module paths ``DENSE_PARAMS`` matches) keeps
  its ``[in, out]`` layout, because the fused edge pipeline takes it as
  its W (DimeNet's residual layers' ``lin2`` is a plain Dense);
- ``bias``, batch-norm ``scale``, per-node ``w_{i}``/``b_{i}``, MFC's
  per-degree ``w_root``/``w_neigh``, GIN's scalar ``eps``, GAT's
  ``att`` tensors, and MACE's raw parameters (an ``IrrepsLinear``'s
  ``w{l}`` [C_in, C_out] and the product basis's ``w{l}_{i}``
  [118, P, C]) are copied as they are;
- with ``batch_stats`` (the JAX package's ``batch_stats`` collection),
  each ``MaskedBatchNorm``'s running ``mean`` and ``var`` become the
  buffers of the same name (``stack``-level ``feature_norm_{i}`` and
  ``gps_{i}/norm{1,2,3}`` for PNA + GPS).

Any other leaf raises, and ``model.load_state_dict(...)`` (strict by
default) raises on keys or shapes that do not match the model.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import re

import numpy as np
import torch

# Modules that are DenseParams twins in the port (their kernel is used
# as [in, out] by a fused kernel): SchNet's conv_{i}/lin2 and a conv node
# head's neigh_{i}. The match is on whole path components, so SAGE's
# plain Dense lin_neigh and DimeNet's before_skip_{k}/lin2 are not.
DENSE_PARAMS = re.compile(r"(?:^|\.)(?:conv_\d+\.lin2|neigh_\d+)$")
# MACE's raw per-l weights: w{l} (IrrepsLinear), w{l}_{i} (the product).
RAW_W = re.compile(r"w\d+(_\d+)?")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def params_from_jax(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX ``params`` tree and, for a
    batch-normed model, its ``batch_stats`` tree (module docstring has
    the mapping)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(batch_stats or {}).items():
        leaf = path.rpartition(".")[2]
        if leaf not in ("mean", "var"):
            raise ValueError(
                f"{path}: no mapping for batch statistic {leaf!r} into the port"
            )
        out[path] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    for path, arr in _flatten(params).items():
        module, _, leaf = path.rpartition(".")
        t = torch.from_numpy(np.array(arr, copy=True))
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{path}: a Dense kernel must be 2-D, got {arr.shape}")
            if DENSE_PARAMS.search(module):
                out[path] = t
            else:
                out[f"{module}.weight"] = t.t().contiguous()
        elif (leaf in ("bias", "scale", "eps", "att") or leaf.startswith(("w_", "b_"))
              or RAW_W.fullmatch(leaf)):
            out[path] = t
        else:
            raise ValueError(
                f"{path}: no mapping for parameter {leaf!r} into the port"
            )
    return out
