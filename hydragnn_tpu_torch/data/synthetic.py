"""Deterministic synthetic dataset with closed-form targets.

Counterpart of ``hydragnn_tpu/data/synthetic.py``
(``deterministic_graph_data``), copied so that the port writes the same
files byte for byte from the same seed. It reimplements the reference's
central test fixture (tests/deterministic_graph_data.py:20-173):
BCC-lattice configurations whose node outputs are x, x^2 + x, x^3 of a
KNN-smoothed node feature and whose graph output is their total sum — so
end-to-end training tests have known learnable structure. Written as
LSMS-format text files so the raw-data ingestion path is exercised,
exactly like the reference tests.

Text format per configuration file (reference
tests/deterministic_graph_data.py:84-88):
  line 0:  GRAPH_OUTPUT [\t GRAPH_OUTPUT_LINEAR]
  line i:  FEATURE  INDEX  X  Y  Z  OUT1  OUT2  OUT3
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def deterministic_graph_data(
    path: str,
    number_configurations: int = 500,
    configuration_start: int = 0,
    unit_cell_x_range: Sequence[int] = (1, 3),
    unit_cell_y_range: Sequence[int] = (1, 3),
    unit_cell_z_range: Sequence[int] = (1, 2),
    number_types: int = 3,
    types: Optional[Sequence[int]] = None,
    number_neighbors: int = 2,
    linear_only: bool = False,
    seed: int = 0,
) -> None:
    """Generate BCC configurations as LSMS text files under ``path``."""
    if types is None:
        types = list(range(number_types))
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    ucx = rng.integers(unit_cell_x_range[0], unit_cell_x_range[1], number_configurations)
    ucy = rng.integers(unit_cell_y_range[0], unit_cell_y_range[1], number_configurations)
    ucz = rng.integers(unit_cell_z_range[0], unit_cell_z_range[1], number_configurations)
    for c in range(number_configurations):
        _write_configuration(
            path,
            c + configuration_start,
            int(ucx[c]),
            int(ucy[c]),
            int(ucz[c]),
            types,
            number_neighbors,
            linear_only,
            rng,
        )


def _write_configuration(
    path, index, ucx, ucy, ucz, types, number_neighbors, linear_only, rng
) -> None:
    n = 2 * ucx * ucy * ucz
    # BCC lattice: corner + body-center atom per unit cell.
    grid = np.array(
        [(x, y, z) for x in range(ucx) for y in range(ucy) for z in range(ucz)],
        dtype=np.float64,
    )
    positions = np.empty((n, 3))
    positions[0::2] = grid
    positions[1::2] = grid + 0.5

    feature = rng.integers(min(types), max(types) + 1, (n, 1)).astype(np.float64)

    if linear_only:
        out_x = feature.copy()
    else:
        # KNN smoothing of the node feature: uniform average over the k
        # nearest neighbors (including self at distance 0), mimicking one
        # hop of message passing.
        out_x = _knn_average(positions, feature, number_neighbors)

    out_x2 = out_x**2 + feature
    out_x3 = out_x**3

    total = float(out_x.sum() + out_x2.sum() + out_x3.sum())
    total_linear = float(out_x.sum())

    lines = []
    if linear_only:
        lines.append(f"{total_linear:.6f}")
    else:
        lines.append(f"{total:.6f}\t{total_linear:.6f}")
    ids = np.arange(n)
    for i in range(n):
        row = [
            f"{feature[i,0]:.6f}",
            f"{float(ids[i]):.6f}",
            f"{positions[i,0]:.6f}",
            f"{positions[i,1]:.6f}",
            f"{positions[i,2]:.6f}",
            f"{out_x[i,0]:.6f}",
            f"{out_x2[i,0]:.6f}",
            f"{out_x3[i,0]:.6f}",
        ]
        lines.append("\t".join(row))
    with open(os.path.join(path, f"output{index}.txt"), "w") as f:
        f.write("\n".join(lines))


def _knn_average(positions: np.ndarray, values: np.ndarray, k: int) -> np.ndarray:
    d2 = np.sum(
        (positions[:, None, :] - positions[None, :, :]) ** 2, axis=-1
    )
    # k nearest including self (sklearn KNeighborsRegressor semantics used
    # by the reference include the query point since it is in the fit set).
    nn_idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return values[nn_idx, 0].mean(axis=1, keepdims=True)
