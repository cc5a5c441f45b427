"""Shared building blocks: activations, the Dense twin, MLPs, init.

Counterpart of ``hydragnn_tpu/models/layers.py``: ``activation``,
``shifted_softplus``, ``DenseParams``, ``MLP`` and ``MaskedBatchNorm``. A flax ``nn.Dense``
becomes ``Dense``, an ``nn.Linear`` (weight ``[out, in]``, the transpose
of flax's ``[in, out]`` kernel) that computes in the promoted type of its
input and weight as flax does, so bf16 inputs meet f32 master weights. ``init_flax_`` draws weights with flax's default
initializers (lecun_normal kernels, zero biases) from a seeded
``torch.Generator``, so the port starts from the same distribution as
the JAX package (not the same numbers: the generators differ).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_LOG2 = math.log(2.0)
# flax's truncated_normal variance scaling divides the std by the
# standard deviation of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2): SchNet's activation (zero at zero)."""
    return F.softplus(x) - _LOG2


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    table = {
        "relu": F.relu,
        "selu": F.selu,
        "prelu": lambda x: F.leaky_relu(x, 0.25),
        "elu": F.elu,
        "lrelu_01": lambda x: F.leaky_relu(x, 0.1),
        "lrelu_025": lambda x: F.leaky_relu(x, 0.25),
        "lrelu_05": lambda x: F.leaky_relu(x, 0.5),
        "sigmoid": torch.sigmoid,
        "softplus": F.softplus,
        "shifted_softplus": shifted_softplus,
        "silu": F.silu,
        "tanh": torch.tanh,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
    }
    if name not in table:
        raise ValueError(f"Unknown activation function: {name}")
    return table[name]


class Dense(nn.Linear):
    """``nn.Linear`` with flax's type promotion: input, weight and bias
    are cast to ``promote(x.dtype, weight.dtype)`` (a bf16 input and an
    f32 weight compute in f32), where ``nn.Linear`` would raise."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class DenseParams(nn.Module):
    """Parameter-only twin of a Dense layer: holds ``kernel`` ``[in,
    out]`` (flax's layout, which the fused edge pipeline takes as its W)
    and ``bias``, and returns them instead of applying the matmul."""

    def __init__(self, in_dim: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self):
        return self.kernel, self.bias


class MLP(nn.Module):
    """Plain MLP: Linear(+act) per layer, optional final activation.
    Layers are named ``dense_{i}`` as in flax."""

    def __init__(
        self,
        in_dim: int,
        features: Sequence[int],
        act: str = "relu",
        final_activation: bool = False,
        use_bias: bool = True,
    ):
        super().__init__()
        self.n_layers = len(features)
        self.act = activation(act)
        self.final_activation = final_activation
        d = in_dim
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(d, f, bias=use_bias))
            d = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n_layers - 1 or self.final_activation:
                x = self.act(x)
        return x


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the unmasked rows of a padded [N, F] array, written
    out as the JAX package's: in training, the masked rows' mean and
    biased variance (divided by the row count) in the input's type, and
    running statistics ``ra = momentum * ra + (1 - momentum) * batch``
    kept in f32 buffers ``mean``/``var`` (flax's ``batch_stats``); in
    eval, the running statistics cast to the input's type. ``scale`` and
    ``bias`` are parameters (a bf16 input meets them in f32, so the
    output is f32, as in flax). ``nn.BatchNorm1d`` differs in all of
    this (unbiased running variance, the other momentum convention, no
    mask), so it is not used."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features, dtype=torch.float32))
        self.register_buffer("var", torch.ones(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.to(x.dtype)[:, None]
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(dim=0) / count
            var = (((x - mean) ** 2) * m).sum(dim=0) / count
            with torch.no_grad():
                keep = self.momentum
                self.mean.copy_(keep * self.mean + (1.0 - keep) * mean.float())
                self.var.copy_(keep * self.var + (1.0 - keep) * var.float())
        else:
            mean = self.mean.to(x.dtype)
            var = self.var.to(x.dtype)
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean) * inv * self.scale + self.bias


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / max(fan_in, 1)) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_flax_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Re-initialize every parameter with flax's defaults, in module
    order, from ``torch.Generator().manual_seed(seed)``: Linear weights
    and DenseParams kernels lecun_normal over their fan-in, biases zero,
    any other tensor named ``w_*`` or ``att`` (per-node head weights
    ``[nodes, in, out]``, MFC's per-degree ``[degrees, in, out]``, GAT's
    ``[heads, width]``) lecun_normal over the fan-in flax gives it (the
    product of every axis but the last), batch-norm ``scale``s one, and
    a scalar ``eps`` its module's ``eps_init`` (GIN). A module that
    defines ``flax_init(leaf, tensor, generator)`` draws its own
    parameters (MACE's per-l weights, EGNN's coordinate gate) from the
    distribution the JAX package gives them."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        owner_mod = module.get_submodule(owner)
        if hasattr(owner_mod, "flax_init") and leaf != "bias":
            owner_mod.flax_init(leaf, p, gen)
        elif leaf == "bias" or leaf.startswith("b_"):
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf == "eps":
            p.fill_(owner_mod.eps_init)
        elif leaf == "weight":  # Dense (nn.Linear): [out, in]
            _lecun_normal_(p, p.shape[1], gen)
        elif leaf in ("kernel", "att") or leaf.startswith("w_"):  # [..., in, out]
            _lecun_normal_(p, p.numel() // p.shape[-1], gen)
        else:
            raise ValueError(f"no flax initializer for parameter {name}")
    return module
