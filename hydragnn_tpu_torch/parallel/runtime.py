"""The superstep settings of a run.

Counterpart of two functions of ``hydragnn_tpu/parallel/runtime.py``
for the single scheme: ``_superstep_from_config`` (the
``Training.Parallelism.superstep`` block) and ``resolve_superstep_k``
(the K a loader's feed stacks per dispatch). The rest of the module
(meshes, data parallelism, multibranch, the input pipeline) comes with
ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import os


def _superstep_from_config(pcfg: dict) -> dict:
    """Resolve the ``Parallelism.superstep`` block (``{steps,
    max_host_bytes}``) with the JAX package's environment overrides
    ``HYDRAGNN_TPU_SUPERSTEP`` (an integer or "auto") and
    ``HYDRAGNN_TPU_SUPERSTEP_MAX_HOST_BYTES``. ``steps`` defaults to
    "auto"; integers >= 1 pin K; anything else raises."""

    def _norm_steps(v) -> "int | str":
        if isinstance(v, str):
            s = v.strip().lower()
            if s == "auto":
                return "auto"
            if s.isdigit():
                return max(1, int(s))
            raise ValueError(
                f"Parallelism.superstep.steps: {v!r} not recognized "
                "(use an integer >= 1 or \"auto\")"
            )
        if isinstance(v, bool):
            raise ValueError(
                "Parallelism.superstep.steps must be an integer or "
                "\"auto\", not a boolean"
            )
        return max(1, int(v))

    ss = dict(pcfg.get("superstep", {}))
    v = os.environ.get("HYDRAGNN_TPU_SUPERSTEP")
    if v is not None and v.strip():
        ss["steps"] = v
    v = os.environ.get("HYDRAGNN_TPU_SUPERSTEP_MAX_HOST_BYTES")
    if v is not None and v.strip():
        ss["max_host_bytes"] = int(v)
    return {
        "superstep_steps": _norm_steps(ss.get("steps", "auto")),
        "superstep_max_host_bytes": max(
            1 << 20, int(ss.get("max_host_bytes", 256 << 20))
        ),
    }


def resolve_superstep_k(settings: dict, loader) -> int:
    """The K one loader's feed stacks per dispatch, for the single
    scheme. ``settings`` is ``_superstep_from_config``'s result. An
    explicit ``steps`` pins K; ``"auto"`` asks
    ``padschedule.auto_superstep_k`` over epoch 0's plan (size metadata
    only), which returns 1 for short or fragmented plans.
    ``HYDRAGNN_TPU_MAX_NUM_BATCH`` (a cap on batches per epoch) forces
    K = 1, since a K-step dispatch could overshoot the cap."""
    if not hasattr(loader, "epoch_plan"):
        return 1
    if os.environ.get("HYDRAGNN_TPU_MAX_NUM_BATCH", "").strip():
        return 1
    steps = settings["superstep_steps"]
    if steps != "auto":
        return max(1, int(steps))
    from hydragnn_tpu_torch.data.padschedule import auto_superstep_k

    return auto_superstep_k(
        list(loader.epoch_plan(0)),
        max_host_bytes=settings["superstep_max_host_bytes"],
    )
