"""Shared-memory sample dataset over the native store.

Counterpart of ``hydragnn_tpu/data/diststore.py`` (the reference's
DDStore-backed DistDataset, hydragnn/utils/datasets/distdataset.py:72-367,
and AdiosDataset's shmem mode, adiosdataset.py:592-642: one local process
holds the data, its siblings attach read-only). Each process of a node
owns the shard of samples it consumes (``padschedule.shard_for_process``),
and the processes of one host share one copy through POSIX shared memory
(``native.SampleStore``).

Record format: a small self-describing pack of the GraphSample numpy
fields (name, dtype, shape, bytes), not a pickle, so a reader in another
process runs no code from the store; ``pack_sample``'s bytes equal the
JAX package's for the same sample.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample

_FIELDS = (
    "x",
    "pos",
    "edge_index",
    "edge_attr",
    "edge_shifts",
    "y_graph",
    "y_node",
    "graph_attr",
    "pe",
    "rel_pe",
    "cell",
    "forces",
)


def pack_sample(s: GraphSample) -> bytes:
    """Serialize a GraphSample to a compact self-describing record."""
    parts: List[bytes] = []
    arrays = []
    for name in _FIELDS:
        v = getattr(s, name)
        if v is not None:
            arrays.append((name, np.ascontiguousarray(v)))
    scalars = {
        "dataset_id": float(s.dataset_id),
        "energy": float("nan") if s.energy is None else float(s.energy),
    }
    head = struct.pack("<II", len(arrays), len(scalars))
    parts.append(head)
    for name, arr in arrays:
        nb = name.encode()
        dt = str(arr.dtype).encode()
        parts.append(
            struct.pack("<III", len(nb), len(dt), arr.ndim)
            + nb
            + dt
            + struct.pack(f"<{arr.ndim}q", *arr.shape)
        )
        parts.append(arr.tobytes())
    for k, v in scalars.items():
        kb = k.encode()
        parts.append(struct.pack("<I", len(kb)) + kb + struct.pack("<d", v))
    return b"".join(parts)


def unpack_sample(buf: bytes) -> GraphSample:
    off = 0
    n_arrays, n_scalars = struct.unpack_from("<II", buf, off)
    off += 8
    fields = {}
    for _ in range(n_arrays):
        ln, ld, nd = struct.unpack_from("<III", buf, off)
        off += 12
        name = buf[off : off + ln].decode()
        off += ln
        dt = buf[off : off + ld].decode()
        off += ld
        shape = struct.unpack_from(f"<{nd}q", buf, off)
        off += 8 * nd
        n_bytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        fields[name] = np.frombuffer(
            buf, dtype=dt, count=int(np.prod(shape)), offset=off
        ).reshape(shape)
        off += n_bytes
    scalars = {}
    for _ in range(n_scalars):
        (ln,) = struct.unpack_from("<I", buf, off)
        off += 4
        k = buf[off : off + ln].decode()
        off += ln
        (v,) = struct.unpack_from("<d", buf, off)
        off += 8
        scalars[k] = v
    energy = scalars.get("energy", float("nan"))
    return GraphSample(
        dataset_id=int(scalars.get("dataset_id", 0)),
        energy=None if np.isnan(energy) else energy,
        **fields,
    )


class StoreDataset:
    """Sequence[GraphSample] view over a native SampleStore.

    Owner process: ``StoreDataset.build(samples, shm_name=...)`` packs
    every sample into the store. Sibling local processes:
    ``StoreDataset.attach(shm_name)`` maps the same memory read-only.
    """

    def __init__(self, store):
        self._store = store

    @classmethod
    def build(
        cls,
        samples: Sequence[GraphSample],
        shm_name: Optional[str] = None,
    ) -> "StoreDataset":
        from hydragnn_tpu_torch.native import SampleStore

        records = [pack_sample(s) for s in samples]
        store = SampleStore([len(r) for r in records], shm_name=shm_name)
        for i, r in enumerate(records):
            store.put(i, r)
        return cls(store)

    @classmethod
    def attach(cls, shm_name: str) -> "StoreDataset":
        from hydragnn_tpu_torch.native import SampleStore

        return cls(SampleStore.attach(shm_name))

    def __len__(self) -> int:
        return len(self._store)

    def __getitem__(self, i: int) -> GraphSample:
        return unpack_sample(self._store.get(i))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        self._store.close()

