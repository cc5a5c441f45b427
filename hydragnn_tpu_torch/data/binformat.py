"""Packed binary graph-dataset container with partial reads.

Counterpart of ``hydragnn_tpu/data/binformat.py`` (the reference's
ADIOS2 layer, hydragnn/utils/datasets/adiosdataset.py): the writer and
the readers are the JAX package's numpy code, copied, so a file either
package writes equals, byte for byte, the one the other writes from the
same samples, and each reads the other's.

File layout (one file, numpy-native, mmap-friendly):

  magic: b"HGTPUBIN1" (9 bytes) + uint64 header length + header JSON
  then for each field, in header order:
    counts  int64[n_samples]            (varying-dim length per sample)
    data    dtype[total, *item_shape]   (concatenation along axis 0)

The header records byte offsets for every array, so a reader maps the
file and slices out one sample's rows without touching the rest (the
ADIOS "direct" partial read). Dataset attributes (``pna_deg``,
``avg_num_neighbors``, ``minmax``, ...) live in the JSON header. The
header also answers, with no sample read, the loader's questions: the
per-sample sizes (``sample_sizes``) and the optional-field map
(``field_widths``, ``label_fields``).

Parallel writing: each process writes its shard file
(``<stem>.p<k>.hgb``); ``BinDataset.open_sharded`` concatenates them
lazily (``MultiBinDataset``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.graph import (
    _ALL_OR_NONE_FIELDS,
    _ZERO_FILL_FIELDS,
    GraphSample,
)

MAGIC = b"HGTPUBIN1"

#: GraphSample array fields, their per-sample varying axis is axis 0.
_ARRAY_FIELDS = (
    "x",
    "pos",
    "edge_index_t",  # stored transposed [e, 2] so axis 0 varies
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
_SCALAR_FIELDS = ("dataset_id", "energy")


def _field_arrays(s: GraphSample, name: str) -> Optional[np.ndarray]:
    if name == "edge_index_t":
        return None if s.edge_index is None else s.edge_index.T
    v = getattr(s, name)
    if v is None:
        return None
    v = np.asarray(v)
    if name in ("y_graph", "graph_attr"):
        return v.reshape(1, -1)
    if name == "cell":
        return v.reshape(1, 3, 3)
    return v


def write_bin_dataset(
    path: str,
    samples: Sequence[GraphSample],
    attrs: Optional[Dict[str, Any]] = None,
) -> None:
    """Write samples into one container file (AdiosWriter.save
    equivalent, adiosdataset.py:110-277)."""
    n = len(samples)
    fields: List[Dict[str, Any]] = []
    blobs: List[np.ndarray] = []

    present: Dict[str, List[np.ndarray]] = {}
    for name in _ARRAY_FIELDS:
        arrs = [_field_arrays(s, name) for s in samples]
        got = [a for a in arrs if a is not None]
        if not got:
            continue
        if len(got) != n:
            raise ValueError(f"field {name!r} present on only some samples")
        present[name] = got

    n_with_energy = sum(s.energy is not None for s in samples)
    if 0 < n_with_energy < n:
        raise ValueError(
            f"field 'energy' present on only some samples "
            f"({n_with_energy}/{n})"
        )
    scalars = {
        "dataset_id": np.array(
            [s.dataset_id for s in samples], dtype=np.int64
        ),
        "energy": (
            np.array([s.energy for s in samples], dtype=np.float64)
            if n_with_energy == n
            else None
        ),
    }

    # Header skeleton with offsets filled in a second pass.
    header: Dict[str, Any] = {
        "n_samples": n,
        "attrs": attrs or {},
        "fields": [],
        "scalars": [],
    }
    payload: List[bytes] = []

    def _append(arr: np.ndarray) -> Dict[str, int]:
        b = np.ascontiguousarray(arr).tobytes()
        off = sum(len(p) for p in payload)
        payload.append(b)
        return {"offset": off, "nbytes": len(b)}

    for name, got in present.items():
        counts = np.array([a.shape[0] for a in got], dtype=np.int64)
        data = np.concatenate(got, axis=0)
        f = {
            "name": name,
            "dtype": str(data.dtype),
            "item_shape": list(data.shape[1:]),
            "counts": _append(counts),
            "data": _append(data),
            "total": int(data.shape[0]),
        }
        header["fields"].append(f)
    for name, arr in scalars.items():
        if arr is None:
            continue
        header["scalars"].append(
            {"name": name, "dtype": str(arr.dtype), "data": _append(arr)}
        )

    hjson = json.dumps(header).encode()
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(struct.pack("<Q", len(hjson)))
        fh.write(hjson)
        for b in payload:
            fh.write(b)


class BinDataset:
    """Sequence[GraphSample] over a container file.

    Modes (AdiosDataset parity, adiosdataset.py:355-1018):
      - ``preload=False`` (default): mmap the file; each __getitem__
        slices one sample's rows (direct partial read).
      - ``preload=True`` (optionally with ``subset``): materialize the
        (subset of) samples into RAM up front.
    ``attrs`` carries the dataset metadata; ``pna_deg`` and
    ``avg_num_neighbors`` attrs are surfaced as attributes so
    update_config finds them (hydragnn_tpu/config/config.py
    _dataset_attr).
    """

    def __init__(
        self,
        path: str,
        *,
        preload: bool = False,
        subset: Optional[Sequence[int]] = None,
    ):
        self.path = path
        with open(path, "rb") as fh:
            magic = fh.read(len(MAGIC))
            if magic != MAGIC:
                raise ValueError(f"{path}: not a HGTPUBIN1 container")
            (hlen,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(hlen))
            self._data_start = fh.tell()
        self._header = header
        self.attrs: Dict[str, Any] = dict(header.get("attrs", {}))
        for k in ("pna_deg", "avg_num_neighbors", "minmax"):
            if k in self.attrs:
                setattr(self, k, self.attrs[k])
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        self._fields: Dict[str, Dict[str, Any]] = {}
        for f in header["fields"]:
            counts = self._array(
                f["counts"], np.int64, (header["n_samples"],)
            )
            starts = np.zeros(header["n_samples"] + 1, dtype=np.int64)
            np.cumsum(counts, out=starts[1:])
            data = self._array(
                f["data"],
                np.dtype(f["dtype"]),
                (f["total"], *f["item_shape"]),
            )
            self._fields[f["name"]] = {"starts": starts, "data": data}
        self._scalars: Dict[str, np.ndarray] = {}
        for srec in header.get("scalars", []):
            self._scalars[srec["name"]] = self._array(
                srec["data"], np.dtype(srec["dtype"]), (header["n_samples"],)
            )

        self._indices = (
            list(range(header["n_samples"]))
            if subset is None
            else list(subset)
        )
        self._cache: Optional[List[GraphSample]] = None
        if preload:
            self._cache = [self._load(i) for i in self._indices]

    def _array(self, rec, dtype, shape) -> np.ndarray:
        start = self._data_start + rec["offset"]
        return (
            self._mm[start : start + rec["nbytes"]]
            .view(dtype)
            .reshape(shape)
        )

    def __len__(self) -> int:
        return len(self._indices)

    def _load(self, raw_i: int) -> GraphSample:
        kw: Dict[str, Any] = {}
        for name, rec in self._fields.items():
            a, b = rec["starts"][raw_i], rec["starts"][raw_i + 1]
            v = np.array(rec["data"][a:b])  # copy out of the map
            if name == "edge_index_t":
                kw["edge_index"] = v.T
            elif name in ("y_graph", "graph_attr"):
                kw[name] = v.reshape(-1)
            elif name == "cell":
                kw[name] = v.reshape(3, 3)
            else:
                kw[name] = v
        if "dataset_id" in self._scalars:
            kw["dataset_id"] = int(self._scalars["dataset_id"][raw_i])
        if "energy" in self._scalars:
            kw["energy"] = float(self._scalars["energy"][raw_i])
        return GraphSample(**kw)

    def __getitem__(self, i: int) -> GraphSample:
        if self._cache is not None:
            return self._cache[i]
        return self._load(self._indices[i])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def field_widths(self) -> Dict[str, Any]:
        """``ensure_fields`` map derived from the header alone — no
        payload reads (see graph.optional_field_widths; the writer
        already enforced all-or-none presence per field)."""
        out: Dict[str, Any] = {}
        for f in self._header["fields"]:
            name, shape = f["name"], f["item_shape"]
            if name in _ZERO_FILL_FIELDS:
                out[name] = int(shape[-1]) if shape else 1
            elif name == "cell":
                out[name] = None
        return out

    def label_fields(self) -> frozenset:
        """Which all-or-none label/position fields this file stores
        (presence is uniform within a file by writer construction) —
        lets MultiBinDataset validate uniformity ACROSS shard files."""
        names = set(self._fields) | set(self._scalars)
        return frozenset(f for f in _ALL_OR_NONE_FIELDS if f in names)

    def sample_sizes(self) -> tuple:
        """Per-sample (node_counts, edge_counts) from the header index —
        lets GraphLoader compute its worst-case PadSpec without reading
        any sample payloads (ADIOS variable_count parity)."""
        node_starts = self._fields["x"]["starts"]
        nodes = (node_starts[1:] - node_starts[:-1])[self._indices]
        if "edge_index_t" in self._fields:
            e_starts = self._fields["edge_index_t"]["starts"]
            edges = (e_starts[1:] - e_starts[:-1])[self._indices]
        else:
            edges = np.zeros(len(self._indices), dtype=np.int64)
        return np.asarray(nodes), np.asarray(edges)

    @classmethod
    def open_sharded(cls, stem: str, **kw) -> "MultiBinDataset":
        """Open ``<stem>.p<k>.hgb`` shard files written by per-process
        writers as one concatenated dataset."""
        shards = []
        k = 0
        while os.path.exists(f"{stem}.p{k}.hgb"):
            shards.append(cls(f"{stem}.p{k}.hgb", **kw))
            k += 1
        if not shards:
            raise FileNotFoundError(f"no shards matching {stem}.p*.hgb")
        return MultiBinDataset(shards)


class MultiBinDataset:
    """Concatenation of datasets (AdiosMultiDataset equivalent,
    adiosdataset.py:1118)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._cum = np.cumsum([0] + [len(d) for d in self.datasets])
        self.attrs: Dict[str, Any] = {}
        for d in reversed(self.datasets):
            self.attrs.update(getattr(d, "attrs", {}))
        # Shards featurized by different SMILES paths (rdkit vs the
        # native parser) are layout-compatible but value-divergent
        # (aromaticity/hybridization drift within one dataset) — fail
        # loudly instead of training on silently mixed features
        # (utils/descriptors.smiles_featurizer_path).
        stamps = {
            getattr(d, "attrs", {}).get("smiles_featurizer")
            for d in self.datasets
        }
        stamps.discard(None)
        if len(stamps) > 1:
            raise ValueError(
                f"shards carry conflicting smiles_featurizer stamps "
                f"{sorted(stamps)}; rebuild all shards in ONE "
                "environment (rdkit and the native parser drift on "
                "aromaticity/hybridization features)"
            )

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self._cum, i, side="right")) - 1
        return self.datasets[k][i - int(self._cum[k])]

    def __iter__(self):
        for d in self.datasets:
            yield from d

    def sample_sizes(self):
        """Concatenated per-shard header sizes (see BinDataset)."""
        parts = [d.sample_sizes() for d in self.datasets]
        return (
            np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
        )

    def field_widths(self):
        """Merged metadata map over shards; None (→ caller falls back
        to the scan) when any shard lacks metadata. Raises on width
        mismatch or non-uniform label presence, the same hazards the
        scan in graph.optional_field_widths guards."""
        maps = []
        labels = []
        for d in self.datasets:
            fw = getattr(d, "field_widths", None)
            m = fw() if callable(fw) else None
            if m is None:
                return None
            maps.append(m)
            lf = getattr(d, "label_fields", None)
            labels.append(lf() if callable(lf) else None)
        out: dict = {}
        for m in maps:
            for k, w in m.items():
                if k in out and out[k] != w:
                    raise ValueError(
                        f"Inconsistent {k} widths across shards: "
                        f"{out[k]} vs {w}"
                    )
                out.setdefault(k, w)
        known = [s for s in labels if s is not None]
        if known and any(s != known[0] for s in known[1:]):
            raise ValueError(
                "Partially-labeled dataset: shards disagree on "
                "label/position fields "
                f"({sorted(set().union(*known) - set.intersection(*map(set, known)))})"
            )
        return out
