"""Pickle-backed datasets.

Counterpart of ``hydragnn_tpu/data/pickledataset.py`` (the reference's
SimplePickleDataset / SimplePickleWriter,
hydragnn/utils/datasets/pickledataset.py:14-182): a ``meta.pkl`` with the
sample count, the attributes and the optional-field map, plus one pickle
file per sample, optionally in subdirectories of 10,000 files.
``offset``/``total`` let several processes write disjoint ranges.

A pickle names its class by module path: a directory the JAX package
wrote holds ``hydragnn_tpu.data.graph.GraphSample`` objects, and a plain
``pickle.load`` would import that package. The reader's unpickler maps
exactly that class name to the port's own ``GraphSample`` (the same
fields), refuses every other name of the JAX package, and resolves the
rest as ``pickle`` does, so datasets already written stay readable and
the port never imports the JAX package.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

from hydragnn_tpu_torch.data.graph import GraphSample, optional_field_widths

_SUBDIR_SIZE = 10000

# The class name the JAX package's writer records for its samples.
_JAX_SAMPLE = ("hydragnn_tpu.data.graph", "GraphSample")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_SAMPLE:
            return GraphSample
        if module == "hydragnn_tpu" or module.startswith("hydragnn_tpu."):
            raise pickle.UnpicklingError(
                f"{module}.{name}: the port reads the JAX package's GraphSample "
                "pickles only, and never imports that package"
            )
        return super().find_class(module, name)


def _load(path: str):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


class SimplePickleDataset:
    """Read side: lazy per-sample loads from ``<path>/<label>-<i>.pkl``."""

    def __init__(self, basedir: str, label: str = "sample"):
        self.basedir = basedir
        self.label = label
        meta = _load(os.path.join(basedir, "meta.pkl"))
        self.total = int(meta["total"])
        self.use_subdir = bool(meta.get("use_subdir", False))
        self.attrs = meta.get("attrs", {})
        self._meta_field_widths = meta.get("field_widths")

    def field_widths(self) -> Optional[dict]:
        """The ``ensure_fields`` map the writer recorded in meta.pkl;
        None where a shard writer (or an older meta) left it out, and
        ``graph.optional_field_widths`` then scans once."""
        return self._meta_field_widths

    def __len__(self) -> int:
        return self.total

    def _fname(self, idx: int) -> str:
        base = f"{self.label}-{idx}.pkl"
        if self.use_subdir:
            return os.path.join(self.basedir, str(idx // _SUBDIR_SIZE), base)
        return os.path.join(self.basedir, base)

    def __getitem__(self, idx: int) -> GraphSample:
        if idx < 0:
            idx += self.total
        if not 0 <= idx < self.total:
            raise IndexError(idx)
        return _load(self._fname(idx))

    def __iter__(self):
        for i in range(self.total):
            yield self[i]


class SimplePickleWriter:
    """Write side: one file per sample plus meta.pkl.

    ``offset`` lets several processes write disjoint ranges of a global
    dataset; ``total`` is the global count recorded in the meta (only the
    process writing the meta needs it). The optional-field map goes into
    the meta only when this writer saw the whole dataset: a shard's own
    map could misstate the global field presence."""

    def __init__(
        self,
        samples: Sequence[GraphSample],
        basedir: str,
        label: str = "sample",
        *,
        offset: int = 0,
        total: Optional[int] = None,
        use_subdir: bool = False,
        attrs: Optional[dict] = None,
        write_meta: bool = True,
    ):
        os.makedirs(basedir, exist_ok=True)
        total = total if total is not None else offset + len(samples)
        for i, sample in enumerate(samples):
            idx = offset + i
            base = f"{label}-{idx}.pkl"
            if use_subdir:
                sub = os.path.join(basedir, str(idx // _SUBDIR_SIZE))
                os.makedirs(sub, exist_ok=True)
                fname = os.path.join(sub, base)
            else:
                fname = os.path.join(basedir, base)
            with open(fname, "wb") as f:
                pickle.dump(sample, f)
        if write_meta:
            widths = None
            if offset == 0 and total == len(samples) and len(samples):
                widths = optional_field_widths(samples)
            with open(os.path.join(basedir, "meta.pkl"), "wb") as f:
                pickle.dump(
                    {
                        "total": total,
                        "use_subdir": use_subdir,
                        "attrs": attrs or {},
                        "field_widths": widths,
                    },
                    f,
                )
