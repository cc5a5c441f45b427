"""CUDA-graph capture of train, eval and served steps.

No one JAX function is the counterpart: ``jax.jit`` compiles each step
once per input shape and the superstep executor
(``hydragnn_tpu/train/loop.py::make_superstep_fn``) runs K steps per
dispatch; the serving engine compiles one executable per budget. On the
card the port captures each step once per shape as a
``torch.cuda.CUDAGraph`` and replays it, so the host issues one replay
where it would issue the step's hundreds of kernels.

``StepGraphs`` holds one graph per key (the step's kind, K, compute
dtype and batch shape, which the padded specs keep static):

- the first time a key is seen the step runs eagerly, as a real step,
  on a side stream (torch's recipe for capturing a whole network): it
  builds the kernel library and leaves nothing lazy for the capture;
- the next time, the step is captured into a graph with a memory pool of
  its own, on static input buffers, and replayed at once; a capture
  executes nothing, so no step is lost or run twice;
- from then on the batch is copied into the static buffers (one pinned
  host buffer, one copy for all K batches: ``StaticBatches``) and the
  graph replayed.

A step must make no host sync and keep its state in tensors it updates
in place (parameters, optimizer state, batch-norm statistics, the
learning rate), since a replay reads and writes the same memory as the
capture did. The outputs of a replay are the graph's own tensors, which
the next replay of the same graph overwrites.

K1 and K2 count their launches on the host (``ops/edge_pipeline.py``),
and a replay makes no host call: so a capture takes back the counts its
recording added, and each replay adds them once more.

Threads (the serving tier's replicas share one card, and a rollover
warms its new engines while the old ones serve) follow one rule: every
CUDA call a thread makes while another thread may be capturing is made
under one process-wide lock, ``GRAPH_LOCK``. Every eager run, capture,
replay and release of every ``StepGraphs`` holds it, and so does the
serving engine's fetch of its outputs to the host; so nothing is issued
to the card while a capture is live, and the launch counts a capture
records are its own. Captures keep torch's default
``capture_error_mode="global"``, so a CUDA call from another thread that
escaped the lock fails the capture loudly instead of corrupting it.
Python's cyclic collector is held off while a capture is open
(``collector_paused``): a collection there may run the destructor of a
dead graph, event or stream, whose CUDA call invalidates the capture.

Each capture is a compile to the run's telemetry
(``utils/telemetry.note_capture``: host bookkeeping, no CUDA call), and
a key's first eager run may be counted (``utils/telemetry.ExecCounter``:
the flops and bytes of its ``executable`` row).

The one host-to-device copy of a step's batches is made here, on the
caller's thread (``StaticBatches.load`` for a replay, ``GraphBatch.to``
for an eager run): its host time and batch count accumulate in
``h2d_seconds`` and ``h2d_batches``, which the epoch loop hands to the
input pipeline's stats.

``record`` captures without keeping the graph and ``put`` keeps it under
a key, releasing the graph it replaces: a caller that must capture
several graphs all or nothing (``ServingEngine.install_executables``)
records them all, then puts them, or ``release``s what it recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from hydragnn_tpu_torch.utils import telemetry

_ALIGN = 256  # bytes between fields in the static buffer

# Held by every eager run, capture and replay (module docstring).
GRAPH_LOCK = threading.RLock()


_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def side_stream(device) -> torch.cuda.Stream:
    """The process's one side stream of a card, on which every
    ``StepGraphs`` and rollout engine makes its eager first-sight runs.
    One stream for all of them, not one per run: cuBLAS keeps a workspace
    for every (handle, stream) pair it has served and frees none, so a
    stream per run would leave a run's workspaces behind it (~64 MiB on an
    H100), and in-process trials (``utils/hpo``) would grow device memory
    run by run."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with GRAPH_LOCK:
        if index not in _SIDE_STREAMS:
            _SIDE_STREAMS[index] = torch.cuda.Stream(index)
        return _SIDE_STREAMS[index]


@contextlib.contextmanager
def collector_paused():
    """Python's automatic cyclic collection off for the block (module
    docstring); restored to what it was on the way out."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _launch_counters() -> tuple:
    from hydragnn_tpu_torch.ops.edge_pipeline import (
        edge_pipeline_bwd_planned,
        edge_pipeline_planned,
    )

    return edge_pipeline_planned, edge_pipeline_bwd_planned


class StaticBatches:
    """Device buffers holding K batches of one shape, as one flat byte
    buffer with a typed view per field (``views[k]`` is batch k as a
    ``GraphBatch`` of device tensors). ``load`` packs K host batches
    into a pinned buffer (two, used in turns) and copies it to the
    device in one asynchronous copy on the current stream."""

    def __init__(self, batches: Sequence, device: torch.device):
        first = batches[0]
        self.layout: List[Tuple[str, torch.dtype, tuple, int, int]] = []
        off = 0
        for name, arr in first.arrays().items():
            t = torch.as_tensor(arr)
            nbytes = t.numel() * t.element_size()
            self.layout.append((name, t.dtype, tuple(t.shape), off, nbytes))
            off += -(-max(nbytes, 1) // _ALIGN) * _ALIGN
        self.stride = off
        self.k = len(batches)
        self.nbytes = self.k * self.stride
        self.flat = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        self._host = [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=True)
                      for _ in range(2)]
        self._copied: List = [None, None]
        self._turn = 0
        self.views = []
        for k in range(self.k):
            base = k * self.stride
            fields = {
                name: self.flat[base + o: base + o + n].view(dt).view(shape)
                for name, dt, shape, o, n in self.layout
            }
            self.views.append(dataclasses.replace(first, **fields))

    def _check(self, name, t, dtype, shape) -> None:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"static batch field {name}: {t.dtype} {tuple(t.shape)} does not "
                f"match the captured {dtype} {shape}"
            )

    def load(self, batches: Sequence) -> None:
        if len(batches) != self.k:
            raise ValueError(f"{len(batches)} batches for a {self.k}-batch buffer")
        host = self._host[self._turn]
        if self._copied[self._turn] is not None:
            # graftlint: disable-next-line=host-sync -- waits for the copy two loads ago before its pinned buffer is rewritten: by then the card has long read it, so the wait is empty on the step path
            self._copied[self._turn].synchronize()
        # graftlint: disable-next-line=host-sync -- a numpy view of the pinned host buffer: host memory, no copy and no wait
        buf = host.numpy()
        for k, b in enumerate(batches):
            arrays = b.arrays()
            if len(arrays) != len(self.layout):
                raise ValueError(
                    f"static batch fields {sorted(arrays)} do not match the captured "
                    f"{[name for name, *_ in self.layout]}"
                )
            base = k * self.stride
            for name, dt, shape, o, n in self.layout:
                src = torch.as_tensor(arrays[name])
                self._check(name, src, dt, shape)
                # graftlint: disable-next-line=host-sync -- the host batch's own arrays (numpy or CPU tensors): host memory, no wait
                buf[base + o: base + o + n] = src.contiguous().numpy().reshape(-1).view("u1")
        self.flat.copy_(host, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._copied[self._turn] = done
        self._turn ^= 1


@dataclasses.dataclass
class CapturedStep:
    """One captured step: its graph, static inputs and outputs, the K1
    and K2 launches one replay makes, and what the capture cost."""

    graph: torch.cuda.CUDAGraph
    static: StaticBatches
    outputs: tuple
    launches: Tuple[int, int]
    seconds: float
    pool_bytes: int


class StepGraphs:
    """The graph cache of one run on one card (module docstring).
    ``run(key, fn, batches)`` returns ``fn``'s outputs for ``batches``
    (host batches: numpy arrays or CPU tensors): eagerly the first time
    ``key`` is seen, from a replay after that. Counts:
    ``eager_runs``, ``captures``, ``replays``; ``capture_seconds`` and
    each graph's ``pool_bytes`` (what its private pool reserved)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"StepGraphs captures on a CUDA device, got {self.device}")
        self.graphs: Dict[Hashable, CapturedStep] = {}
        self._seen: set = set()
        self._side = side_stream(self.device)
        self.eager_runs = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.h2d_seconds = 0.0
        self.h2d_batches = 0

    def run(self, key: Hashable, fn: Callable, batches: Sequence, counter=None) -> tuple:
        """``counter`` (a ``utils/telemetry.ExecCounter``) counts the
        key's first, eager run; a key seen before leaves it unrun."""
        if key not in self.graphs:
            if key not in self._seen:
                self._seen.add(key)
                return self.eager(fn, batches, counter=counter, key=key)
            self.capture(key, fn, batches)
        return self.replay(key, batches)

    def eager(self, fn: Callable, batches: Sequence, counter=None, key=None) -> tuple:
        """``fn`` run eagerly on the batches, on the side stream (under
        ``counter``'s count when one is given, for the graph of ``key``)."""
        with GRAPH_LOCK:
            t0 = time.perf_counter()
            dev = [b.to(self.device) for b in batches]
            self.h2d_seconds += time.perf_counter() - t0
            self.h2d_batches += len(batches)
            cur = torch.cuda.current_stream(self.device)
            self._side.wait_stream(cur)
            with torch.cuda.stream(self._side):
                if counter is None:
                    out = fn(dev)
                else:
                    counter.graphs, counter.graph_key = self, key
                    out = counter.run(fn, dev)
            cur.wait_stream(self._side)
            self.eager_runs += 1
            return out

    def capture(self, key: Hashable, fn: Callable, batches: Sequence) -> CapturedStep:
        """Capture ``fn`` on static buffers shaped like ``batches`` into a
        graph with its own memory pool, kept under ``key``. Executes
        nothing; raises if the capture fails (a host sync in ``fn``, for
        one)."""
        with GRAPH_LOCK:
            if key in self.graphs:
                raise RuntimeError(f"step {key} is captured already")
            step = self.record(fn, batches)
            self.put(key, step)
            return step

    def record(self, fn: Callable, batches: Sequence) -> CapturedStep:
        """Capture ``fn`` as ``capture`` does, without keeping the graph:
        the caller ``put``s or ``release``s it."""
        with GRAPH_LOCK:
            return self._record(fn, batches)

    def _record(self, fn: Callable, batches: Sequence) -> CapturedStep:
        t0 = time.perf_counter()
        static = StaticBatches(batches, self.device)
        counters = _launch_counters()
        before = tuple(c.launches for c in counters)
        # graftlint: disable-next-line=host-sync -- the sync before a capture: the pool's reserved bytes are read against an idle card; once per key, never per replay
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # as torch.cuda.graph does on entry
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), torch.cuda.graph(graph):
            outputs = fn(static.views)
        recorded = tuple(c.launches - b for c, b in zip(counters, before))
        for c, b in zip(counters, before):
            c.launches = b
        # graftlint: disable-next-line=host-sync -- the sync after a capture: the capture's seconds and pool bytes; once per key, never per replay
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        step = CapturedStep(graph, static, tuple(outputs), recorded, seconds,
                            torch.cuda.memory_reserved(self.device) - reserved)
        self.captures += 1
        self.capture_seconds += seconds
        telemetry.note_capture(seconds)
        return step

    def put(self, key: Hashable, step: CapturedStep) -> None:
        """Keep ``step`` under ``key``, releasing the graph it replaces."""
        with GRAPH_LOCK:
            old = self.graphs.get(key)
            self.graphs[key] = step
            self._seen.add(key)
            if old is not None:
                self.release(old)

    def release(self, *steps: CapturedStep) -> None:
        """Free graphs no key holds any more: each graph and its memory
        pool, static buffers and outputs. The caller keeps no reference
        to a released step's outputs."""
        with GRAPH_LOCK:
            for step in steps:
                step.graph.reset()
                step.static = step.outputs = None
            torch.cuda.empty_cache()

    def clear(self) -> None:
        """Release every graph (the owner's teardown)."""
        with GRAPH_LOCK:
            steps = list(self.graphs.values())
            self.graphs.clear()
            self._seen.clear()
            self.release(*steps)

    def replay(self, key: Hashable, batches: Sequence) -> tuple:
        """Copy ``batches`` into ``key``'s static buffers and replay it."""
        with GRAPH_LOCK:
            step = self.graphs[key]
            t0 = time.perf_counter()
            step.static.load(batches)
            self.h2d_seconds += time.perf_counter() - t0
            self.h2d_batches += len(batches)
            step.graph.replay()
            for c, n in zip(_launch_counters(), step.launches):
                c.launches += n
            self.replays += 1
            return step.outputs

    def memory(self) -> dict:
        """Graphs, the bytes their pools reserved at capture, and the
        allocator's current reserved and allocated bytes."""
        return {
            "graphs": len(self.graphs),
            "pool_bytes": sum(s.pool_bytes for s in self.graphs.values()),
            "reserved_bytes": torch.cuda.memory_reserved(self.device),
            "allocated_bytes": torch.cuda.memory_allocated(self.device),
        }
