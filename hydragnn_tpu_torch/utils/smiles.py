"""SMILES -> GraphSample without rdkit.

Counterpart of ``hydragnn_tpu/utils/smiles.py`` (numpy only; it builds
the port's ``data/graph.GraphSample``), which its tests hold against
the JAX module bit for bit.

The reference's SMILES ingestion (csce / ogb drivers) runs through
rdkit: `generate_graphdata_from_smilestr`
(hydragnn/utils/descriptors_and_embeddings/smiles_utils.py:36-127)
parses the string, adds explicit hydrogens, and emits
  x        = [one-hot(atom type over `types`),
              atomic_number, is_aromatic, sp, sp2, sp3, num_h_neighbors]
  edges    = both directions per bond, sorted by (src * N + dst)
  edge_attr= one-hot bond type over (single, double, triple, aromatic)

rdkit is not in this image (the reference additionally vendors 1,007
LoC of xyz2mol for the reverse 3D->bond-graph direction), so this
module implements the forward path natively: a small parser for the
SMILES grammar subset that covers the reference's target datasets
(organic-subset + bracket atoms, branches, ring closures incl. %nn,
bond symbols - = # : / \\, dots, charges, explicit H counts), implicit
hydrogen assignment by standard valence, and the same feature layout.

Deliberate approximations (documented, heuristic where rdkit runs a
full perception pass):
- hybridization flags: aromatic or >=1 double bond -> sp2; a triple
  bond or two cumulated doubles -> sp; other heavy atoms -> sp3
  (hydrogens get no flag, as in rdkit's s-orbital result).
- no kekulization: aromatic bonds stay the distinct 4th bond class,
  exactly as the reference featurizes them.
- stereo (/ \\ @) is parsed and ignored; isotopes are ignored.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "parse_smiles",
    "graph_sample_from_smiles",
    "get_node_attribute_name",
    "ParsedMolecule",
    "molecule_from_positions",
]

# Default valences for implicit-H assignment (Daylight organic subset).
_DEFAULT_VALENCE = {
    "B": 3,
    "C": 4,
    "N": 3,
    "O": 2,
    "P": 3,
    "S": 2,
    "F": 1,
    "Cl": 1,
    "Br": 1,
    "I": 1,
}

_ATOMIC_NUMBER = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Fe": 26, "Cu": 29,
    "Zn": 30, "As": 33, "Se": 34, "Br": 35, "Sn": 50, "Te": 52, "I": 53,
}

# Covalent radii in Angstrom (Cordero et al. 2008, public tabulation)
# for the bond-perception path below.
_COVALENT_RADIUS = {
    1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84, 6: 0.76, 7: 0.71,
    8: 0.66, 9: 0.57, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 19: 2.03, 20: 1.76, 26: 1.32, 29: 1.32,
    30: 1.22, 33: 1.19, 34: 1.20, 35: 1.20, 50: 1.39, 52: 1.38,
    53: 1.39,
}
_SYMBOL_BY_Z = {z: s for s, z in _ATOMIC_NUMBER.items()}

_ORGANIC = ("Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I")
_AROMATIC_ORGANIC = ("b", "c", "n", "o", "p", "s")

_BOND_ORDER = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5, "/": 1.0, "\\": 1.0}
#: bond-class index in the one-hot edge feature (reference bonds dict,
#: smiles_utils.py:51)
_BOND_CLASS = {1.0: 0, 2.0: 1, 3.0: 2, 1.5: 3}

_BRACKET_RE = re.compile(
    r"^(?P<isotope>\d+)?(?P<symbol>[A-Z][a-z]?|[a-z])(?P<chiral>@{1,2})?"
    r"(?P<hcount>H\d*)?(?P<charge>[+-]+\d*|\+\d+|-\d+)?(?::\d+)?$"
)


@dataclass
class _Atom:
    symbol: str
    aromatic: bool
    charge: int = 0
    explicit_h: Optional[int] = None  # None = assign by valence


@dataclass
class ParsedMolecule:
    """Atoms + bonds, hydrogens materialized as real atoms."""

    symbols: List[str] = field(default_factory=list)
    atomic_numbers: List[int] = field(default_factory=list)
    aromatic: List[bool] = field(default_factory=list)
    charges: List[int] = field(default_factory=list)
    bonds: List[Tuple[int, int, float]] = field(default_factory=list)

    @property
    def num_atoms(self) -> int:
        return len(self.symbols)


def _tokenize(s: str):
    """Yield atom/bond/structure tokens."""
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "[":
            j = s.index("]", i)
            yield ("bracket", s[i + 1 : j])
            i = j + 1
        elif s[i : i + 2] in ("Cl", "Br"):
            yield ("atom", s[i : i + 2])
            i += 2
        elif ch in "BCNOPSFI":
            yield ("atom", ch)
            i += 1
        elif ch in _AROMATIC_ORGANIC:
            yield ("aromatic_atom", ch)
            i += 1
        elif ch in "-=#:/\\":
            yield ("bond", ch)
            i += 1
        elif ch == "%":
            yield ("ring", s[i + 1 : i + 3])
            i += 3
        elif ch.isdigit():
            yield ("ring", ch)
            i += 1
        elif ch == "(":
            yield ("open", ch)
            i += 1
        elif ch == ")":
            yield ("close", ch)
            i += 1
        elif ch == ".":
            yield ("dot", ch)
            i += 1
        else:
            raise ValueError(f"Unsupported SMILES token {ch!r} in {s!r}")


def _parse_bracket(body: str) -> _Atom:
    m = _BRACKET_RE.match(body)
    if m is None:
        raise ValueError(f"Unparseable bracket atom [{body}]")
    sym = m.group("symbol")
    aromatic = sym[0].islower()
    symbol = sym.capitalize() if aromatic else sym
    h = m.group("hcount")
    if h is None:
        explicit_h = 0  # bracket atoms carry NO implicit hydrogens
    else:
        explicit_h = int(h[1:]) if len(h) > 1 else 1
    c = m.group("charge") or ""
    if c:
        sign = 1 if c[0] == "+" else -1
        digits = c.lstrip("+-")
        charge = sign * (int(digits) if digits else len(c))
    else:
        charge = 0
    return _Atom(symbol, aromatic, charge, explicit_h)


def parse_smiles(s: str, *, with_hydrogen: bool = True) -> ParsedMolecule:
    """Parse a SMILES string into atoms + bonds.

    ``with_hydrogen=True`` materializes implicit AND bracket-explicit
    hydrogens as real atoms bonded by single bonds — the reference
    always featurizes with ``Chem.AddHs`` (smiles_utils.py:53)."""
    atoms: List[_Atom] = []
    bonds: List[Tuple[int, int, float]] = []
    prev: Optional[int] = None
    pending_bond: Optional[float] = None
    stack: List[Optional[int]] = []
    rings: Dict[str, Tuple[int, Optional[float]]] = {}

    def _add_bond(i: int, j: int, order: Optional[float]):
        if order is None:
            order = (
                1.5
                if atoms[i].aromatic and atoms[j].aromatic
                else 1.0
            )
        bonds.append((i, j, order))

    for kind, tok in _tokenize(s):
        if kind in ("atom", "aromatic_atom", "bracket"):
            if kind == "bracket":
                atom = _parse_bracket(tok)
            else:
                atom = _Atom(tok.capitalize(), kind == "aromatic_atom")
            atoms.append(atom)
            idx = len(atoms) - 1
            if prev is not None:
                _add_bond(prev, idx, pending_bond)
            prev = idx
            pending_bond = None
        elif kind == "bond":
            pending_bond = _BOND_ORDER[tok]
        elif kind == "ring":
            if prev is None:
                raise ValueError(
                    f"Ring-closure digit {tok!r} before any atom in {s!r}"
                )
            if tok in rings:
                j, order0 = rings.pop(tok)
                if (
                    pending_bond is not None
                    and order0 is not None
                    and pending_bond != order0
                ):
                    raise ValueError(
                        f"Ring closure {tok!r} in {s!r} carries "
                        f"conflicting bond orders ({order0} vs "
                        f"{pending_bond})"
                    )
                _add_bond(prev, j, pending_bond or order0)
            else:
                rings[tok] = (prev, pending_bond)
            pending_bond = None
        elif kind == "open":
            stack.append(prev)
        elif kind == "close":
            if not stack:
                raise ValueError(f"Unmatched ')' in {s!r}")
            prev = stack.pop()
        elif kind == "dot":
            prev = None
            pending_bond = None
    if rings:
        raise ValueError(f"Unclosed ring bond(s) {sorted(rings)} in {s!r}")

    mol = ParsedMolecule()
    order_sum = [0.0] * len(atoms)
    for i, j, o in bonds:
        order_sum[i] += o
        order_sum[j] += o
    for a in atoms:
        mol.symbols.append(a.symbol)
        mol.atomic_numbers.append(_ATOMIC_NUMBER[a.symbol])
        mol.aromatic.append(a.aromatic)
        mol.charges.append(a.charge)
    mol.bonds = list(bonds)

    if with_hydrogen:
        for i, a in enumerate(atoms):
            if a.explicit_h is not None:
                n_h = a.explicit_h
            else:
                # Charged atoms are always bracket atoms (explicit_h
                # set), so plain valence lookup suffices here.
                default = _DEFAULT_VALENCE.get(a.symbol)
                if default is None:
                    n_h = 0
                else:
                    n_h = max(0, default - int(np.ceil(order_sum[i])))
            for _ in range(n_h):
                mol.symbols.append("H")
                mol.atomic_numbers.append(1)
                mol.aromatic.append(False)
                mol.charges.append(0)
                mol.bonds.append((i, len(mol.symbols) - 1, 1.0))
    return mol


def get_node_attribute_name(types: Dict[str, int]):
    """Parity with smiles_utils.get_node_attribute_name:17-32 (the HSP*
    names are the hybridization flags)."""
    names = ["atom" + k for k in types] + [
        "atomicnumber",
        "IsAromatic",
        "HSP",
        "HSP2",
        "HSP3",
        "Hprop",
    ]
    return names, [1] * len(names)


def graph_sample_from_smiles(
    smiles: str,
    y: Sequence[float],
    types: Dict[str, int],
    *,
    graph_target: bool = True,
    mol: Optional[ParsedMolecule] = None,
):
    """SMILES string -> GraphSample with the reference feature layout
    (generate_graphdata_from_smilestr, smiles_utils.py:36-127).
    Pass ``mol`` (a hydrogen-materialized parse_smiles result) to skip
    re-parsing when the caller already parsed the string."""
    from hydragnn_tpu_torch.data.graph import GraphSample

    if mol is None:
        mol = parse_smiles(smiles, with_hydrogen=True)
    n = mol.num_atoms

    # Hybridization heuristic (see module docstring).
    n_double = [0] * n
    n_triple = [0] * n
    h_neigh = [0] * n
    for i, j, o in mol.bonds:
        if o == 2.0:
            n_double[i] += 1
            n_double[j] += 1
        elif o == 3.0:
            n_triple[i] += 1
            n_triple[j] += 1
        if mol.symbols[j] == "H":
            h_neigh[i] += 1
        if mol.symbols[i] == "H":
            h_neigh[j] += 1

    x = np.zeros((n, len(types) + 6), dtype=np.float32)
    for i in range(n):
        sym = mol.symbols[i]
        if sym not in types:
            raise KeyError(
                f"atom {sym!r} not in the `types` map {sorted(types)}"
            )
        x[i, types[sym]] = 1.0
        x[i, len(types) + 0] = float(mol.atomic_numbers[i])
        x[i, len(types) + 1] = 1.0 if mol.aromatic[i] else 0.0
        if sym != "H":
            sp = n_triple[i] > 0 or n_double[i] >= 2
            sp2 = not sp and (mol.aromatic[i] or n_double[i] == 1)
            x[i, len(types) + 2] = 1.0 if sp else 0.0
            x[i, len(types) + 3] = 1.0 if sp2 else 0.0
            x[i, len(types) + 4] = 0.0 if (sp or sp2) else 1.0
        x[i, len(types) + 5] = float(h_neigh[i])

    edge_index, edge_attr = bonds_to_edges(
        [(i, j, _BOND_CLASS[o]) for i, j, o in mol.bonds], n
    )

    y_arr = np.asarray(y, dtype=np.float32).reshape(-1)
    return GraphSample(
        x=x,
        pos=None,
        edge_index=edge_index,
        edge_attr=edge_attr,
        y_graph=y_arr if graph_target else None,
        y_node=None if graph_target else np.tile(y_arr, (n, 1)),
    )


def bonds_to_edges(classed_bonds, n: int):
    """(src, dst, bond_class) triples -> (edge_index, edge_attr): both
    directions per bond, sorted by src * N + dst, one-hot over the 4
    bond classes (reference perm sort, smiles_utils.py:80-86). The ONE
    place the edge layout is defined — both the native featurizer and
    the rdkit branch in utils/descriptors.py route through it, so the
    two paths cannot drift apart."""
    src, dst, cls = [], [], []
    for i, j, c in classed_bonds:
        src += [i, j]
        dst += [j, i]
        cls += [int(c)] * 2
    if not src:
        return (
            np.zeros((2, 0), dtype=np.int64),
            np.zeros((0, 4), dtype=np.float32),
        )
    order = np.argsort(np.asarray(src) * n + np.asarray(dst))
    edge_index = np.stack(
        [np.asarray(src)[order], np.asarray(dst)[order]]
    ).astype(np.int64)
    edge_attr = np.eye(4, dtype=np.float32)[np.asarray(cls)[order]]
    return edge_index, edge_attr


def molecule_from_positions(
    pos: np.ndarray,
    atomic_numbers: Sequence[int],
    *,
    tolerance: float = 1.2,
) -> ParsedMolecule:
    """3-D coordinates -> bond graph (the reverse direction the
    reference vendors 1,007 LoC of xyz2mol for,
    hydragnn/utils/descriptors_and_embeddings/xyz2mol.py).

    Minimal perception: a bond exists where the interatomic distance is
    below ``tolerance x (r_cov_i + r_cov_j)`` (Cordero covalent radii).
    Bond ORDER is then assigned greedily from remaining valence —
    shortest relative distances first get promoted to double/triple
    while both endpoints have spare valence. Promotion is restricted to
    pairs of C/N/O/S: the relative-distance thresholds below are
    calibrated on organic multiple bonds, and applying them to e.g.
    metal-ligand or Si/P contacts would mislabel compressed single
    bonds — outside the calibrated chemistry every bond stays single.
    No aromaticity/charge perception (xyz2mol's charge enumeration is
    out of scope); good enough to featurize xyz/LSMS-style datasets
    through the same ``graph_sample_from_smiles`` feature layout via
    the returned ParsedMolecule."""
    pos = np.asarray(pos, dtype=np.float64)
    z = [int(v) for v in atomic_numbers]
    n = len(z)
    if pos.shape != (n, 3):
        raise ValueError(f"pos shape {pos.shape} != ({n}, 3)")

    mol = ParsedMolecule(
        # Elements outside the symbol table (transition metals etc.)
        # get a placeholder symbol — bond perception only needs radii,
        # which fall back below; the featurizer will reject placeholder
        # symbols unless the caller's `types` map includes them.
        symbols=[_SYMBOL_BY_Z.get(v, f"El{v}") for v in z],
        atomic_numbers=list(z),
        aromatic=[False] * n,
        charges=[0] * n,
    )
    # Candidate bonds by covalent-radius criterion.
    cands = []
    for i in range(n):
        for j in range(i + 1, n):
            d = float(np.linalg.norm(pos[i] - pos[j]))
            r = _COVALENT_RADIUS.get(z[i], 1.5) + _COVALENT_RADIUS.get(
                z[j], 1.5
            )
            if d <= tolerance * r:
                cands.append((d / r, i, j))
    cands.sort()
    order = {(i, j): 1.0 for _, i, j in cands}

    # Remaining valence after single bonds; promote shortest bonds.
    # Unknown valences (metals, placeholder elements) get 0 spare —
    # their bonds stay single rather than guessing; hydrogen is capped
    # at 1 so a compressed X-H contact can never become a double bond.
    val = {
        i: (
            1
            if mol.symbols[i] == "H"
            else _DEFAULT_VALENCE.get(mol.symbols[i], 1)
        )
        for i in range(n)
    }
    used = {i: 0.0 for i in range(n)}
    for _, i, j in cands:
        used[i] += 1.0
        used[j] += 1.0
    # Promotion thresholds in relative distance d / (r_i + r_j):
    # C=C 1.33A / 1.52A = 0.88, C#C 1.20A / 1.52A = 0.79. Calibrated on
    # organic multiple bonds only — see the promotable set above.
    promotable = {"C", "N", "O", "S"}
    for rel, i, j in cands:
        if not (
            mol.symbols[i] in promotable and mol.symbols[j] in promotable
        ):
            continue
        for threshold in (0.92, 0.82):  # -> double, then -> triple
            if (
                rel < threshold
                and used[i] < val[i]
                and used[j] < val[j]
            ):
                order[(i, j)] += 1.0
                used[i] += 1.0
                used[j] += 1.0

    mol.bonds = [(i, j, order[(i, j)]) for _, i, j in cands]
    return mol
