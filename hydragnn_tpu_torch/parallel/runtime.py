"""Parallel execution runtime: distributed init, plan resolution, wiring.

Counterpart of ``hydragnn_tpu/parallel/runtime.py``. The JAX package is
one process driving a mesh of D devices; the port follows PyTorch's
idiom, one process per card under ``torch.distributed``, and its D
"devices" are the ranks of the default process group. Rank r on a node
uses ``cuda:LOCAL_RANK`` (``device.resolve_device``).

- ``maybe_initialize_distributed`` is ``init_process_group`` from the
  JAX package's rendezvous variables (``HYDRAGNN_TPU_COORDINATOR``,
  ``HYDRAGNN_TPU_NUM_PROCESSES``, ``HYDRAGNN_TPU_PROCESS_ID``), torchrun's
  (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or SLURM's
  and Open MPI's task variables with ``MASTER_ADDR``/``MASTER_PORT``;
  NCCL on a card, gloo on the CPU or where the caller names it (a group
  the caller made first is kept).
- ``ParallelPlan``/``plan_from_config`` resolve ``Training.Parallelism``
  as the JAX package does (``scheme``, ``data``, ``fsdp``, ``zero``,
  ``HYDRAGNN_TPU_MESH``, ``HYDRAGNN_TPU_USE_FSDP``, packing, supersteps,
  ``prefetch`` and the ``pipeline`` feed); ``"auto"`` is dp when the
  world holds more than one rank.
- A JAX *process* is a node here: every rank of a node gets the node's
  datasets and builds the same coordinated plan, and takes its own slot
  of each step (``parallel/dp.DPLoader``), so the ranks of one node
  reproduce the one-process D-device mesh bit for bit. Across nodes the
  data is sharded per node (``shard_dataset_for_process``) and padded to
  cross-node spec schedules, the JAX package's multi-host form. The
  ranks per node come from ``LOCAL_WORLD_SIZE`` (torchrun),
  ``SLURM_NTASKS_PER_NODE`` or ``OMPI_COMM_WORLD_LOCAL_SIZE``; without
  them every rank counts as one node's.
- ``wrap_loader``, ``prepare_state`` and ``gather_to_host`` wire a
  plan's loaders and state; ``_superstep_from_config`` and
  ``resolve_superstep_k`` give the superstep K (dp folds the plan to
  steps first, ``padschedule.dp_step_plan``). ``wrap_loader`` puts the
  feed under every single and dp loader as the JAX package does: the
  collation workers (``data/pipeline.ParallelPipelineLoader``) where
  ``pipeline_workers`` > 0, which on a host of 4 or more CPUs is the
  default, else the prefetch thread (``data/prefetch.PrefetchLoader``).

The graph-sharded MPNN (``parallel/graphshard``) is not a
``Training.Parallelism`` scheme, as in the JAX package: its driver
(``drivers/giant_graph``) makes its own ``graph`` mesh.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from hydragnn_tpu_torch.parallel.mesh import DataMesh, make_mesh


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name, "").strip()
        if v:
            return int(v)
    return None


def local_rank() -> int:
    """This rank's index on its node (torchrun's ``LOCAL_RANK``, SLURM's
    ``SLURM_LOCALID``, Open MPI's ``OMPI_COMM_WORLD_LOCAL_RANK``; 0)."""
    v = _env_int("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
    return 0 if v is None else v


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def ranks_per_node() -> int:
    """Ranks of one node (module docstring); the whole world without a
    launcher's word."""
    w = world_size()
    v = _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE", "OMPI_COMM_WORLD_LOCAL_SIZE")
    if v is None or v <= 0 or w % v:
        return w
    return v


def process_count() -> int:
    """The JAX package's ``jax.process_count()``: nodes."""
    return world_size() // ranks_per_node()


def process_index() -> int:
    return rank() // ranks_per_node()


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Initialize the default process group when a launcher's variables
    ask for more than one rank (module docstring), or when
    ``HYDRAGNN_TPU_COORDINATOR`` names a rendezvous (also for one rank,
    which gives NCCL at world 1). Idempotent: a group the caller made is
    kept. Returns whether a group exists."""
    if dist.is_initialized():
        return True
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    coord = os.environ.get("HYDRAGNN_TPU_COORDINATOR", "").strip()
    if coord:
        nproc = int(os.environ["HYDRAGNN_TPU_NUM_PROCESSES"])
        pid = int(os.environ["HYDRAGNN_TPU_PROCESS_ID"])
        init = coord if "://" in coord else f"tcp://{coord}"
    else:
        nproc = _env_int("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE") or 1
        if nproc <= 1:
            return False
        pid = _env_int("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK") or 0
        if not os.environ.get("MASTER_ADDR"):
            raise RuntimeError(
                f"{nproc} tasks but no rendezvous: set MASTER_ADDR and MASTER_PORT "
                "(or HYDRAGNN_TPU_COORDINATOR=host:port)"
            )
        init = "env://"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init, world_size=nproc, rank=pid)
    return True


@dataclass(frozen=True)
class ParallelPlan:
    """Resolved parallelism of one run (the JAX package's). ``mesh`` is
    the ranks' layout (``parallel/mesh.DataMesh``: ``data`` x ``fsdp``);
    ``fsdp`` shards parameters with FSDP2, over the data axis itself
    (``fsdp_axis "data"``, ZeRO) or over the ``fsdp`` axis (HSDP).
    ``prefetch`` is the prefetch thread's depth (0: none);
    ``pipeline_workers`` > 0 feeds through that many collation workers
    (``pipeline_depth`` chunks in flight, ``pipeline_chunk`` batches a
    chunk, ``pipeline_packed`` pooled packed assembly)."""

    scheme: str  # "single" | "dp" | "multibranch"
    mesh: Optional[DataMesh] = None
    fsdp: bool = False
    fsdp_axis: str = "fsdp"
    devices_per_branch: Optional[Tuple[int, ...]] = None
    prefetch: int = 2
    pipeline_workers: int = 0
    pipeline_depth: int = 4
    pipeline_packed: bool = True
    pipeline_chunk: int = 4
    packing: "bool | str" = "auto"
    packing_max_budgets: int = 2
    packing_slack: Optional[float] = None
    packing_max_graphs: Optional[int] = None
    superstep_steps: "int | str" = "auto"
    superstep_max_host_bytes: int = 256 << 20

    @property
    def data_parallel_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.data


def _parse_mesh_env(spec: str) -> dict:
    """``"data=4,fsdp=2"`` as an axes dict."""
    axes = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    return axes


def _pipeline_from_config(pcfg: dict) -> dict:
    """The ``Parallelism.pipeline`` block (``workers``, ``depth``,
    ``packed``, ``chunk``) with the overrides
    ``HYDRAGNN_TPU_PIPELINE_{WORKERS,DEPTH,CHUNK,PACKED}``, as the JAX
    package resolves it. Without a ``workers`` setting the count adapts
    to the host: ``min(4, cpus - 2)`` on 4 or more CPUs, else 0 (the
    serial feed, where workers would only compete with the step for
    the cores); ``workers: 0`` asks for the serial feed anywhere."""
    pl = dict(pcfg.get("pipeline", {}))
    for key, env in (("workers", "HYDRAGNN_TPU_PIPELINE_WORKERS"),
                     ("depth", "HYDRAGNN_TPU_PIPELINE_DEPTH"),
                     ("chunk", "HYDRAGNN_TPU_PIPELINE_CHUNK")):
        v = os.environ.get(env)
        if v is not None and v.strip():
            pl[key] = int(v)
    v = os.environ.get("HYDRAGNN_TPU_PIPELINE_PACKED")
    if v is not None and v.strip():
        pl["packed"] = v.strip().lower() not in ("0", "false", "no")
    workers = pl.get("workers")
    if workers is None:
        n_cpu = os.cpu_count() or 1
        workers = 0 if n_cpu < 4 else min(4, n_cpu - 2)
    return {
        "pipeline_workers": max(0, int(workers)),
        "pipeline_depth": max(1, int(pl.get("depth", 4))),
        "pipeline_packed": bool(pl.get("packed", True)),
        "pipeline_chunk": max(1, int(pl.get("chunk", 4))),
    }


def _packing_from_config(pcfg: dict) -> dict:
    """The ``Parallelism.packing`` block with the overrides
    ``HYDRAGNN_TPU_PACKING`` and ``HYDRAGNN_TPU_PACKING_BUDGETS``, in the
    JAX package's strict grammar."""

    def _norm_enabled(v) -> "bool | str":
        if isinstance(v, str):
            s = v.strip().lower()
            if s == "auto":
                return "auto"
            if s in ("1", "true", "yes", "on"):
                return True
            if s in ("", "0", "false", "no", "off"):
                return False
            raise ValueError(
                f"Parallelism.packing.enabled: {v!r} not recognized "
                '(use true/false/"auto")'
            )
        return bool(v)

    pk = dict(pcfg.get("packing", {}))
    v = os.environ.get("HYDRAGNN_TPU_PACKING")
    if v is not None and v.strip():
        pk["enabled"] = v
    v = os.environ.get("HYDRAGNN_TPU_PACKING_BUDGETS")
    if v is not None and v.strip():
        pk["max_budgets"] = int(v)
    slack, max_graphs = pk.get("slack"), pk.get("max_graphs")
    return {
        "packing": _norm_enabled(pk.get("enabled", "auto")),
        "packing_max_budgets": max(1, int(pk.get("max_budgets", 2))),
        "packing_slack": None if slack is None else float(slack),
        "packing_max_graphs": None if max_graphs is None else int(max_graphs),
    }


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


def resolve_superstep_k(settings, loader) -> int:
    """The K one loader's feed stacks per dispatch. ``settings`` is a
    ``ParallelPlan`` or ``_superstep_from_config``'s dict. Multibranch
    returns 1. An explicit ``steps`` pins K; ``"auto"`` asks
    ``padschedule.auto_superstep_k`` over epoch 0's plan (size metadata
    only), which returns 1 for short or fragmented plans; under dp the
    plan is folded to steps first (``padschedule.dp_step_plan``) and the
    host-memory cap divided by the node's slots.
    ``HYDRAGNN_TPU_MAX_NUM_BATCH`` (a cap on batches per epoch) forces
    K = 1, since a K-step dispatch could overshoot the cap."""
    if isinstance(settings, ParallelPlan):
        if settings.scheme not in ("single", "dp"):
            return 1
        scheme, n_slots = settings.scheme, settings.data_parallel_size
        steps, max_bytes = settings.superstep_steps, settings.superstep_max_host_bytes
    else:
        scheme, n_slots = "single", 1
        steps, max_bytes = settings["superstep_steps"], settings["superstep_max_host_bytes"]
    if not hasattr(loader, "epoch_plan"):
        return 1
    if os.environ.get("HYDRAGNN_TPU_MAX_NUM_BATCH", "").strip():
        return 1
    if steps != "auto":
        return max(1, int(steps))
    from hydragnn_tpu_torch.data.padschedule import auto_superstep_k, dp_step_plan

    plan0 = list(loader.epoch_plan(0))
    if scheme == "dp":
        n_local = max(n_slots // process_count(), 1)
        plan0, _ = dp_step_plan(plan0, n_local)
        max_bytes //= n_local
    return auto_superstep_k(plan0, max_host_bytes=max_bytes)


def plan_from_config(config: dict, n_devices: Optional[int] = None) -> ParallelPlan:
    """Resolve the parallelism plan from ``Training.Parallelism``
    (``scheme`` "auto"/"single"/"dp"/"multibranch", ``data`` (-1 fills),
    ``fsdp``, ``zero``, ``prefetch``, ``pipeline``, ``packing``,
    ``superstep``) and the overrides ``HYDRAGNN_TPU_MESH="data=4,fsdp=2"``,
    ``HYDRAGNN_TPU_USE_FSDP`` and ``_pipeline_from_config``'s, as the JAX
    package resolves it over
    ``n_devices`` (the world size by default): "auto" is dp over every
    rank when there is more than one, single otherwise."""
    n_dev = world_size() if n_devices is None else int(n_devices)
    training = config.get("NeuralNetwork", {}).get("Training", {})
    pcfg = dict(training.get("Parallelism", {}))
    env_mesh = os.environ.get("HYDRAGNN_TPU_MESH")
    if env_mesh:
        axes = _parse_mesh_env(env_mesh)
        pcfg.setdefault("scheme", "dp")
        pcfg["data"] = axes.get("data", pcfg.get("data", -1))
        if "fsdp" in axes:
            pcfg["fsdp"] = axes["fsdp"]
    scheme = pcfg.get("scheme", "auto")
    feed = {"prefetch": int(pcfg.get("prefetch", 2)), **_pipeline_from_config(pcfg)}
    packing = _packing_from_config(pcfg)
    superstep = _superstep_from_config(pcfg)
    if scheme == "auto":
        scheme = "dp" if n_dev > 1 else "single"
    if scheme == "single":
        return ParallelPlan(scheme="single", **feed, **packing, **superstep)
    if scheme not in ("dp", "multibranch"):
        raise ValueError(f"Parallelism.scheme {scheme!r} not in auto/single/dp/multibranch")
    zero = bool(pcfg.get("zero", False)) or os.environ.get(
        "HYDRAGNN_TPU_USE_FSDP") in ("1", "true")
    fsdp_size = int(pcfg.get("fsdp", 1))
    data_size = int(pcfg.get("data", -1))
    if data_size == -1:
        data_size = n_dev // fsdp_size
    n_used = data_size * fsdp_size
    if n_used > n_dev:
        raise ValueError(
            f"Parallelism needs {n_used} devices (data={data_size} x "
            f"fsdp={fsdp_size}), only {n_dev} visible"
        )
    return ParallelPlan(
        scheme=scheme,
        mesh=make_mesh({"data": data_size, "fsdp": fsdp_size}),
        fsdp=fsdp_size > 1 or zero,
        fsdp_axis="fsdp" if fsdp_size > 1 else "data",
        **feed,
        **packing,
        **superstep,
    )


def shard_dataset_for_process(samples: Sequence) -> Sequence:
    """This node's equal-size shard of a dataset: the contiguous block
    partition (``padschedule.shard_for_process``) truncated to one length
    on every node, so per-epoch step counts agree with no collective. One
    node keeps the whole dataset: a list or tuple as a list, a container
    with ``__len__`` and ``__getitem__`` (``BinDataset``) as it is, read
    lazily; across nodes the shard's samples are read by index.
    Anything else is materialized first."""
    if not (hasattr(samples, "__getitem__") and hasattr(samples, "__len__")):
        samples = list(samples)
    p = process_count()
    if p == 1:
        return list(samples) if isinstance(samples, (list, tuple)) else samples
    from hydragnn_tpu_torch.data.padschedule import shard_for_process

    block = shard_for_process(len(samples), process_index(), p)
    return [samples[k] for k in list(block)[: len(samples) // p]]


def wrap_loader(plan: ParallelPlan, loader, *, superstep: bool = True, device=None):
    """A GraphLoader wrapped for the plan, as the JAX package wraps it:

    - dp: the collation workers (``data/pipeline.ParallelPipelineLoader``)
      where ``pipeline_workers`` > 0, then this rank's slot of every step
      (``parallel/dp.DPLoader``, grouping K same-spec steps where
      ``resolve_superstep_k`` says so, its slot's entries collated by the
      workers), then the prefetch thread (``data/prefetch.PrefetchLoader``)
      where ``prefetch`` > 0;
    - single: the workers delivering superstep groups of K where
      ``pipeline_workers`` > 0; else ``data/loader.SuperstepLoader`` for
      K > 1 and the prefetch thread.

    ``superstep=False`` pins K = 1 (the per-batch test pass). ``device``
    is where the consumer runs the steps: on a card every batch is copied
    to it before the next is taken, so the workers recycle their packed
    buffers after ``hold`` deliveries (``DPLoader.required_hold`` covers
    the prefetch queue); elsewhere each batch keeps its own buffers."""
    from hydragnn_tpu_torch.data.pipeline import ParallelPipelineLoader
    from hydragnn_tpu_torch.data.prefetch import PrefetchLoader

    k = resolve_superstep_k(plan, loader) if superstep else 1
    workers = plan.pipeline_workers
    pipe_kw = dict(workers=workers, depth=plan.pipeline_depth, packed=plan.pipeline_packed,
                   chunk=plan.pipeline_chunk,
                   recycle=device is not None and torch.device(device).type == "cuda")
    if plan.scheme == "dp":
        from hydragnn_tpu_torch.parallel.dp import DPLoader

        if workers > 0:
            loader = ParallelPipelineLoader(
                loader, hold=DPLoader.required_hold(plan.prefetch), **pipe_kw)
        loader = DPLoader(loader, plan.mesh, superstep_k=k)
        return PrefetchLoader(loader, depth=plan.prefetch) if plan.prefetch > 0 else loader
    if workers > 0:
        return ParallelPipelineLoader(loader, superstep_k=k, **pipe_kw)
    if k > 1:
        from hydragnn_tpu_torch.data.loader import SuperstepLoader

        loader = SuperstepLoader(loader, k)
    return PrefetchLoader(loader, depth=plan.prefetch) if plan.prefetch > 0 else loader


def feed_line(plan: ParallelPlan) -> str:
    """The feed ``wrap_loader`` builds for the plan, as a run logs it
    (the JAX runner's line where the workers run; the prefetch thread
    sits above the dp slot loader, and is the whole feed without
    workers)."""
    if plan.pipeline_workers > 0 and plan.scheme != "multibranch":
        line = (f"input pipeline: workers={plan.pipeline_workers} "
                f"depth={plan.pipeline_depth} packed={plan.pipeline_packed} "
                f"chunk={plan.pipeline_chunk}")
        return line + (f", prefetch={plan.prefetch}" if plan.scheme == "dp" else "")
    return f"input feed: serial, prefetch={plan.prefetch}"


def prepare_state(plan: ParallelPlan, state, device):
    """Place the ``TrainState`` for the plan: parameters and buffers
    broadcast from rank 0 (replicated), then, with ``plan.fsdp``, the
    model sharded with FSDP2 (``parallel/dp.replicate_state``)."""
    if plan.mesh is None:
        return state
    from hydragnn_tpu_torch.parallel.dp import replicate_state

    return replicate_state(state, plan, device)


def gather_to_host(tensor: torch.Tensor) -> torch.Tensor:
    """A full CPU copy of ``tensor`` on every rank: a DTensor (FSDP's
    shards) is all-gathered (every rank must call this together), a
    plain tensor copied."""
    full = getattr(tensor, "full_tensor", None)
    # graftlint: disable-next-line=host-sync -- the checkpoint snapshot's copy itself: callers (CheckpointWriter.save, save_checkpoint) fetch the state once per save, never per step
    return (full() if callable(full) else tensor).detach().cpu()
