"""Train state and precision policy.

Counterpart of ``hydragnn_tpu/train/state.py``: ``TrainState``,
``resolve_precision`` and ``cast_batch``. Precision follows the JAX
package: "bf16" keeps f32 master parameters and casts the batch's input
leaves to bf16 (explicit casts, not autocast; layers then promote as
flax does), "fp32" computes in f32, "fp64" in f64 (CPU only: the
kernels take f32 and bf16). Targets always keep their f32 values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from hydragnn_tpu_torch.train.optimizer import OptaxOptimizer

PRECISIONS = ("bf16", "fp32", "fp64")
_TARGETS = frozenset({"y_graph", "y_node", "energy", "forces"})


@dataclasses.dataclass
class TrainState:
    """What a run trains: the model (which holds the parameters), its
    optimizer, the number of optimizer steps taken, and, on the card,
    the run's CUDA-graph cache of its steps (``train/capture.StepGraphs``;
    None runs them eagerly, and ``eager_reason`` then says why where a
    plan decided it: ``parallel/dp.eager_reason``).

    ``step`` is the host's count, which the loop's cursors use;
    ``step_t`` the same count as a 0-d int64 tensor on the model's
    device, which every train step advances inside its body (a skipped
    step too) and the ``nan`` fault rules compare against: a captured
    graph would bake a host int in."""

    model: torch.nn.Module
    optimizer: OptaxOptimizer
    step: int = 0
    graphs: Optional[object] = None
    eager_reason: Optional[str] = None
    step_t: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.step_t is None:
            p = next(self.model.parameters(), None)
            dev = p.device if p is not None else torch.device("cpu")
            self.step_t = torch.full((), int(self.step), dtype=torch.int64, device=dev)

    def set_step(self, step: int) -> None:
        """Set both counts (a restore): the device one in place, so
        captured steps keep advancing it."""
        self.step = int(step)
        self.step_t.fill_(int(step))


def resolve_precision(
    precision: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[torch.dtype, torch.dtype]:
    """(param_dtype, compute_dtype) for a precision name; fp64 on a CUDA
    ``device`` raises."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"Unsupported precision {precision!r}; pick one of {PRECISIONS}"
        )
    if precision == "bf16":
        return torch.float32, torch.bfloat16
    if precision == "fp64":
        if device is not None and torch.device(device).type == "cuda":
            raise ValueError(
                "precision fp64 runs on the CPU only: the port's CUDA kernels "
                "take float32 and bfloat16"
            )
        return torch.float64, torch.float64
    return torch.float32, torch.float32


def cast_batch(batch, compute_dtype: torch.dtype):
    """The batch with every floating input leaf cast to
    ``compute_dtype``; target fields keep full precision."""
    cast = {
        name: t.to(compute_dtype)
        for name, t in batch.arrays().items()
        if name not in _TARGETS and t.is_floating_point() and t.dtype != compute_dtype
    }
    return dataclasses.replace(batch, **cast) if cast else batch
