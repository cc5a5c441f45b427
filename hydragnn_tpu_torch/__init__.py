"""hydragnn_tpu_torch: the PyTorch/CUDA port of ``hydragnn_tpu``.

The package mirrors the JAX package's layout (``data/``, ``ops/``,
``models/``, ``serve/``, ``export.py``); each module names its JAX
counterpart in its docstring. It imports ``torch`` and numpy only —
never ``jax``, ``flax``, ``optax`` or ``hydragnn_tpu`` — and keeps its
own copies of the host logic it needs (collate, the block planner, the
packer, the synthetic request generator).

What runs today is the serving path for SchNet: ``DynamicBatcher`` ->
``ServingEngine`` -> ``export.make_forward`` -> ``MultiHeadGraphModel``,
with the fused edge pipeline (``ops/edge_pipeline.py``) running as a
hand-written CUDA kernel on the card. Training and the other stacks are
later work (ROADMAP.md).

Importing the package is cheap on purpose: it builds no CUDA code and
imports none of its submodules. The kernel is compiled with ``nvcc`` at
its first launch (``ops/cuda_build.py``).
"""

__all__: list = []
