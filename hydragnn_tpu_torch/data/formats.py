"""Raw structure-file readers: XYZ and AtomEye CFG.

Counterpart of ``hydragnn_tpu/data/formats.py``, copied so the samples
equal the JAX package's array for array: self-contained parsers in place
of the reference's ASE-backed loaders (hydragnn/utils/datasets/
xyzdataset.py:15-70 reads .xyz with a ``<name>_energy.txt`` sidecar;
hydragnn/preprocess/cfg_raw_dataset_loader.py:25-106 reads AtomEye .cfg
with per-atom auxiliary fields and a ``<name>.bulk`` sidecar).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from hydragnn_tpu_torch.data.graph import GraphSample

# Atomic symbols -> Z for XYZ files (index = Z - 1).
_SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In "
    "Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf "
    "Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am "
    "Cm Bk Cf Es Fm Md No Lr Rf Db Sg Bh Hs Mt Ds Rg Cn Nh Fl Mc Lv Ts Og"
).split()
ATOMIC_NUMBERS: Dict[str, int] = {s: i + 1 for i, s in enumerate(_SYMBOLS)}


def read_xyz_file(path: str) -> GraphSample:
    """Parse a standard .xyz file: node features = atomic numbers;
    graph target read from the ``<stem>_energy.txt`` sidecar when
    present (reference xyzdataset.py:56-68)."""
    # Keep blank lines: line 2 is the (possibly empty) comment, and the
    # n atom rows follow it positionally.
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    zs = np.zeros((n, 1), np.float32)
    pos = np.zeros((n, 3), np.float32)
    for i, ln in enumerate(lines[2 : 2 + n]):
        parts = ln.split()
        sym = parts[0]
        z = (
            ATOMIC_NUMBERS.get(sym)
            or ATOMIC_NUMBERS.get(sym.capitalize())
            or (int(sym) if sym.isdigit() else None)
        )
        if z is None:
            raise ValueError(f"{path}: unknown element {sym!r}")
        zs[i, 0] = z
        pos[i] = [float(x) for x in parts[1:4]]
    y_graph = None
    sidecar = os.path.splitext(path)[0] + "_energy.txt"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            y_graph = np.array(
                [float(f.readline().split()[0])], np.float32
            )
    return GraphSample(x=zs, pos=pos, y_graph=y_graph)


def read_xyz_directory(path: str) -> List[GraphSample]:
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".xyz"):
            out.append(read_xyz_file(os.path.join(path, name)))
    return out


def read_cfg_file(path: str) -> GraphSample:
    """Parse an AtomEye (extended) CFG file.

    Node features follow the reference's column layout
    (cfg_raw_dataset_loader.py:79-88): [Z, mass, aux...] with positions
    recovered from reduced coordinates via the H0 cell matrix; the
    ``<stem>.bulk`` sidecar provides the graph target.
    """
    n = None
    cell = np.zeros((3, 3), np.float64)
    entry_count = None
    aux_names: List[str] = []
    rows: List[List[float]] = []
    zrow: List[float] = []
    mrow: List[float] = []
    no_velocity = False
    cur_mass = None
    cur_z = None

    with open(path) as f:
        for raw in f:
            ln = raw.strip()
            if not ln or ln.startswith("#"):
                continue
            m = re.match(r"Number of particles\s*=\s*(\d+)", ln)
            if m:
                n = int(m.group(1))
                continue
            m = re.match(
                r"H0\((\d),(\d)\)\s*=\s*([-\d.eE+]+)", ln
            )
            if m:
                cell[int(m.group(1)) - 1, int(m.group(2)) - 1] = float(
                    m.group(3)
                )
                continue
            if ln.startswith(".NO_VELOCITY."):
                no_velocity = True
                continue
            m = re.match(r"entry_count\s*=\s*(\d+)", ln)
            if m:
                entry_count = int(m.group(1))
                continue
            m = re.match(r"auxiliary\[(\d+)\]\s*=\s*(\S+)", ln)
            if m:
                aux_names.append(m.group(2))
                continue
            if "=" in ln:  # other header assignments (A = 1.0 Angstrom, R, ...)
                continue
            if re.match(r"[A-Za-z]", ln):  # element symbol line
                sym = ln.split()[0]
                z = ATOMIC_NUMBERS.get(sym) or ATOMIC_NUMBERS.get(
                    sym.capitalize()
                )
                if z is not None:
                    cur_z = z
                    continue
            parts = ln.split()
            if len(parts) == 1:
                # mass line in the two-line (mass, symbol) block form
                try:
                    cur_mass = float(parts[0])
                    continue
                except ValueError:
                    continue
            # per-atom data line: s1 s2 s3 [vels] aux...
            vals = [float(v) for v in parts]
            rows.append(vals)
            zrow.append(float(cur_z if cur_z is not None else 0))
            mrow.append(float(cur_mass if cur_mass is not None else 0.0))

    if n is None or not rows:
        raise ValueError(f"{path}: not a CFG file")
    data = np.asarray(rows)
    s = data[:, :3]
    pos = (s @ cell).astype(np.float32)
    n_skip = 3 if no_velocity else 6
    aux = data[:, n_skip:]
    z = np.asarray(zrow, np.float32).reshape(-1, 1)
    mass = np.asarray(mrow, np.float32).reshape(-1, 1)
    x = np.concatenate([z, mass, aux.astype(np.float32)], axis=1)
    y_graph = None
    sidecar = os.path.splitext(path)[0] + ".bulk"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            y_graph = np.array(
                [float(f.readline().split()[0])], np.float32
            )
    return GraphSample(
        x=x, pos=pos, cell=cell.astype(np.float32), y_graph=y_graph
    )


def read_cfg_directory(path: str) -> List[GraphSample]:
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".cfg"):
            out.append(read_cfg_file(os.path.join(path, name)))
    return out
