"""Atomic descriptors and SMILES -> graph conversion.

Counterpart of ``hydragnn_tpu/utils/descriptors.py``:
- ``atomicdescriptors``: element-property embeddings from the JAX
  module's own table for Z = 1..86 (electronegativity, covalent radius,
  atomic weight, period, group, valence electrons, first ionization
  energy), minmax-normalized over the chosen elements, with optional
  one-hot columns; symbols map to Z through ``data/formats.ATOMIC_NUMBERS``.
  No ``mendeleev`` is used, in either package.
- ``generate_graphdata_from_smilestr`` takes rdkit when it imports, else
  the native parser (``utils/smiles.py``: the same feature layout, bond-
  class edge features, heuristic hybridization flags), in the JAX
  module's order; ``smiles_featurizer_path`` says which.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from hydragnn_tpu_torch.data.formats import ATOMIC_NUMBERS
from hydragnn_tpu_torch.data.graph import GraphSample

# Per-element rows Z=1..86: (electronegativity Pauling, covalent radius
# pm, atomic weight, period, group, valence electrons, first ionization
# energy eV). NaN = undefined (noble-gas EN etc.).
_NAN = float("nan")
_PROPS = {
    1: (2.20, 31, 1.008, 1, 1, 1, 13.598),
    2: (_NAN, 28, 4.0026, 1, 18, 2, 24.587),
    3: (0.98, 128, 6.94, 2, 1, 1, 5.392),
    4: (1.57, 96, 9.0122, 2, 2, 2, 9.323),
    5: (2.04, 84, 10.81, 2, 13, 3, 8.298),
    6: (2.55, 76, 12.011, 2, 14, 4, 11.260),
    7: (3.04, 71, 14.007, 2, 15, 5, 14.534),
    8: (3.44, 66, 15.999, 2, 16, 6, 13.618),
    9: (3.98, 57, 18.998, 2, 17, 7, 17.423),
    10: (_NAN, 58, 20.180, 2, 18, 8, 21.565),
    11: (0.93, 166, 22.990, 3, 1, 1, 5.139),
    12: (1.31, 141, 24.305, 3, 2, 2, 7.646),
    13: (1.61, 121, 26.982, 3, 13, 3, 5.986),
    14: (1.90, 111, 28.085, 3, 14, 4, 8.152),
    15: (2.19, 107, 30.974, 3, 15, 5, 10.487),
    16: (2.58, 105, 32.06, 3, 16, 6, 10.360),
    17: (3.16, 102, 35.45, 3, 17, 7, 12.968),
    18: (_NAN, 106, 39.948, 3, 18, 8, 15.760),
    19: (0.82, 203, 39.098, 4, 1, 1, 4.341),
    20: (1.00, 176, 40.078, 4, 2, 2, 6.113),
    21: (1.36, 170, 44.956, 4, 3, 3, 6.561),
    22: (1.54, 160, 47.867, 4, 4, 4, 6.828),
    23: (1.63, 153, 50.942, 4, 5, 5, 6.746),
    24: (1.66, 139, 51.996, 4, 6, 6, 6.767),
    25: (1.55, 139, 54.938, 4, 7, 7, 7.434),
    26: (1.83, 132, 55.845, 4, 8, 8, 7.902),
    27: (1.88, 126, 58.933, 4, 9, 9, 7.881),
    28: (1.91, 124, 58.693, 4, 10, 10, 7.640),
    29: (1.90, 132, 63.546, 4, 11, 11, 7.726),
    30: (1.65, 122, 65.38, 4, 12, 12, 9.394),
    31: (1.81, 122, 69.723, 4, 13, 3, 5.999),
    32: (2.01, 120, 72.630, 4, 14, 4, 7.900),
    33: (2.18, 119, 74.922, 4, 15, 5, 9.789),
    34: (2.55, 120, 78.971, 4, 16, 6, 9.752),
    35: (2.96, 120, 79.904, 4, 17, 7, 11.814),
    36: (3.00, 116, 83.798, 4, 18, 8, 14.000),
    37: (0.82, 220, 85.468, 5, 1, 1, 4.177),
    38: (0.95, 195, 87.62, 5, 2, 2, 5.695),
    39: (1.22, 190, 88.906, 5, 3, 3, 6.217),
    40: (1.33, 175, 91.224, 5, 4, 4, 6.634),
    41: (1.60, 164, 92.906, 5, 5, 5, 6.759),
    42: (2.16, 154, 95.95, 5, 6, 6, 7.092),
    43: (1.90, 147, 98.0, 5, 7, 7, 7.28),
    44: (2.20, 146, 101.07, 5, 8, 8, 7.361),
    45: (2.28, 142, 102.91, 5, 9, 9, 7.459),
    46: (2.20, 139, 106.42, 5, 10, 10, 8.337),
    47: (1.93, 145, 107.87, 5, 11, 11, 7.576),
    48: (1.69, 144, 112.41, 5, 12, 12, 8.994),
    49: (1.78, 142, 114.82, 5, 13, 3, 5.786),
    50: (1.96, 139, 118.71, 5, 14, 4, 7.344),
    51: (2.05, 139, 121.76, 5, 15, 5, 8.608),
    52: (2.10, 138, 127.60, 5, 16, 6, 9.010),
    53: (2.66, 139, 126.90, 5, 17, 7, 10.451),
    54: (2.60, 140, 131.29, 5, 18, 8, 12.130),
    55: (0.79, 244, 132.91, 6, 1, 1, 3.894),
    56: (0.89, 215, 137.33, 6, 2, 2, 5.212),
    57: (1.10, 207, 138.91, 6, 3, 3, 5.577),
    58: (1.12, 204, 140.12, 6, 3, 4, 5.539),
    59: (1.13, 203, 140.91, 6, 3, 5, 5.473),
    60: (1.14, 201, 144.24, 6, 3, 6, 5.525),
    61: (1.13, 199, 145.0, 6, 3, 7, 5.582),
    62: (1.17, 198, 150.36, 6, 3, 8, 5.644),
    63: (1.20, 198, 151.96, 6, 3, 9, 5.670),
    64: (1.20, 196, 157.25, 6, 3, 10, 6.150),
    65: (1.22, 194, 158.93, 6, 3, 11, 5.864),
    66: (1.23, 192, 162.50, 6, 3, 12, 5.939),
    67: (1.24, 192, 164.93, 6, 3, 13, 6.022),
    68: (1.24, 189, 167.26, 6, 3, 14, 6.108),
    69: (1.25, 190, 168.93, 6, 3, 15, 6.184),
    70: (1.26, 187, 173.05, 6, 3, 16, 6.254),
    71: (1.27, 175, 174.97, 6, 3, 17, 5.426),
    72: (1.30, 187, 178.49, 6, 4, 4, 6.825),
    73: (1.50, 170, 180.95, 6, 5, 5, 7.550),
    74: (2.36, 162, 183.84, 6, 6, 6, 7.864),
    75: (1.90, 151, 186.21, 6, 7, 7, 7.834),
    76: (2.20, 144, 190.23, 6, 8, 8, 8.438),
    77: (2.20, 141, 192.22, 6, 9, 9, 8.967),
    78: (2.28, 136, 195.08, 6, 10, 10, 8.959),
    79: (2.54, 136, 196.97, 6, 11, 11, 9.226),
    80: (2.00, 132, 200.59, 6, 12, 12, 10.438),
    81: (1.62, 145, 204.38, 6, 13, 3, 6.108),
    82: (2.33, 146, 207.2, 6, 14, 4, 7.417),
    83: (2.02, 148, 208.98, 6, 15, 5, 7.286),
    84: (2.00, 140, 209.0, 6, 16, 6, 8.414),
    85: (2.20, 150, 210.0, 6, 17, 7, 9.318),
    86: (_NAN, 150, 222.0, 6, 18, 8, 10.749),
}
_PROP_NAMES = (
    "electronegativity",
    "covalent_radius",
    "atomic_weight",
    "period",
    "group_id",
    "valence_electrons",
    "ionization_energy",
)


class atomicdescriptors:
    """Element-property embedding table (reference atomicdescriptors,
    descriptors_and_embeddings/atomicdescriptors.py:12-120). Properties
    are minmax-normalized over the selected element set; optional
    one-hot columns for the integer-valued properties."""

    def __init__(
        self,
        embeddingfilename: Optional[str] = None,
        overwritten: bool = True,
        element_types: Optional[Sequence[str]] = ("C", "H", "O", "N", "F", "S"),
        one_hot: bool = False,
    ):
        if (
            embeddingfilename
            and os.path.exists(embeddingfilename)
            and not overwritten
        ):
            with open(embeddingfilename) as f:
                self.atom_embeddings = json.load(f)
            return
        if element_types is None:
            zs = sorted(_PROPS)
        else:
            zs = sorted(ATOMIC_NUMBERS[e] for e in element_types)
            missing = [z for z in zs if z not in _PROPS]
            if missing:
                raise ValueError(
                    f"no property data for Z={missing} (table covers 1..86)"
                )
        table = np.array([_PROPS[z] for z in zs], dtype=np.float64)
        # minmax-normalize each property over the element set; NaNs -> 0.
        lo = np.nanmin(table, axis=0)
        hi = np.nanmax(table, axis=0)
        rng = np.where(hi > lo, hi - lo, 1.0)
        norm = (table - lo) / rng
        norm = np.nan_to_num(norm, nan=0.0)
        self.one_hot = one_hot
        self.atom_embeddings: Dict[str, List[float]] = {}
        for i, z in enumerate(zs):
            row = list(norm[i])
            if one_hot:
                type_oh = [0.0] * len(zs)
                type_oh[i] = 1.0
                row = type_oh + row
            self.atom_embeddings[str(z)] = row
        if embeddingfilename:
            with open(embeddingfilename, "w") as f:
                json.dump(self.atom_embeddings, f)

    def get_atom_features(self, atomtype) -> np.ndarray:
        """Feature row for an element (symbol or Z)."""
        z = (
            ATOMIC_NUMBERS[atomtype]
            if isinstance(atomtype, str)
            else int(atomtype)
        )
        return np.asarray(self.atom_embeddings[str(z)], np.float32)


def get_node_attribute_name(types: Sequence[str]):
    """(names, dims) of the SMILES node feature columns (reference
    smiles_utils.py:18-33)."""
    names = ["atom" + k for k in types] + [
        "atomicnumber",
        "IsAromatic",
        "HSP",
        "HSP2",
        "HSP3",
        "Hprop",
    ]
    return names, [1] * len(names)


def smiles_featurizer_path() -> str:
    """"rdkit" or "native" — which branch
    ``generate_graphdata_from_smilestr`` takes in this environment.

    The two branches are layout-compatible but NOT value-identical
    (rdkit perceives aromaticity in Kekule-written rings and runs full
    hybridization; the native parser flags lowercase atoms and uses a
    heuristic). Writers of SMILES-derived datasets should stamp
    ``{"smiles_featurizer": smiles_featurizer_path()}`` into the
    dataset ``attrs`` (SimplePickleWriter / write_bin_dataset both take
    ``attrs``); MultiBinDataset rejects shard sets whose stamps
    disagree, so mixed-environment feature drift fails loudly instead
    of silently."""
    try:
        # Mirror the EXACT branch condition of the featurizer below: a
        # broken install whose top-level package imports but whose Chem
        # extension doesn't would otherwise stamp "rdkit" on
        # natively-featurized data.
        from rdkit import Chem  # noqa: F401
        from rdkit.Chem.rdchem import HybridizationType  # noqa: F401

        return "rdkit"
    except ImportError:
        return "native"


def generate_graphdata_from_smilestr(
    smilestr: str,
    ytarget,
    types: Dict[str, int],
    var_config: Optional[dict] = None,
) -> GraphSample:
    """SMILES string -> GraphSample (reference smiles_utils.py:35-100:
    one-hot atom type + [Z, aromatic, sp, sp2, sp3, #H] node features,
    bond edges both directions).

    Uses rdkit when installed (full perception, exact reference
    semantics); otherwise falls back to the native parser
    (hydragnn_tpu_torch/utils/smiles.py — same feature layout plus bond-class
    edge_attr, heuristic hybridization flags)."""
    try:
        from rdkit import Chem
        from rdkit.Chem.rdchem import HybridizationType
    except ImportError:
        from hydragnn_tpu_torch.utils.smiles import graph_sample_from_smiles

        return graph_sample_from_smiles(
            smilestr, np.asarray(ytarget, np.float32).reshape(-1), types
        )

    from rdkit.Chem.rdchem import BondType as BT

    ps = Chem.SmilesParserParams()
    ps.removeHs = False
    mol = Chem.MolFromSmiles(smilestr, ps)
    if mol is None:
        raise ValueError(f"unparsable SMILES: {smilestr!r}")
    mol = Chem.AddHs(mol)
    n = mol.GetNumAtoms()
    type_idx = np.zeros((n, len(types)), np.float32)
    extra = np.zeros((n, 6), np.float32)
    for i, atom in enumerate(mol.GetAtoms()):
        type_idx[i, types[atom.GetSymbol()]] = 1.0
        extra[i, 0] = atom.GetAtomicNum()
        extra[i, 1] = float(atom.GetIsAromatic())
        hyb = atom.GetHybridization()
        extra[i, 2] = float(hyb == HybridizationType.SP)
        extra[i, 3] = float(hyb == HybridizationType.SP2)
        extra[i, 4] = float(hyb == HybridizationType.SP3)
        extra[i, 5] = atom.GetTotalNumHs(includeNeighbors=True)
    # Same edge LAYOUT as the native fallback and the reference
    # (smiles_utils.py:74-86), via bonds_to_edges. NOTE the two
    # paths are layout-compatible, not value-identical: rdkit runs full
    # aromaticity perception (Kekule-written rings like C1=CC=CC=C1
    # come back aromatic), the native parser flags aromaticity from
    # lowercase SMILES atoms only — don't mix shards built with and
    # without rdkit in one dataset.
    from hydragnn_tpu_torch.utils.smiles import bonds_to_edges

    bond_class = {BT.SINGLE: 0, BT.DOUBLE: 1, BT.TRIPLE: 2, BT.AROMATIC: 3}
    classed = []
    for bond in mol.GetBonds():
        bt = bond.GetBondType()
        if bt not in bond_class:
            # Fail loudly like the native path would — a dative or
            # quadruple bond silently one-hotted as "single" corrupts
            # the bond-class feature.
            raise ValueError(
                f"unsupported bond type {bt} in {smilestr!r}; the "
                "4-class edge feature covers single/double/triple/"
                "aromatic only"
            )
        classed.append(
            (bond.GetBeginAtomIdx(), bond.GetEndAtomIdx(), bond_class[bt])
        )
    edge_index, edge_attr = bonds_to_edges(classed, n)
    x = np.concatenate([type_idx, extra], axis=1)
    return GraphSample(
        x=x,
        edge_index=edge_index,
        edge_attr=edge_attr,
        y_graph=np.asarray(ytarget, np.float32).reshape(-1),
    )
