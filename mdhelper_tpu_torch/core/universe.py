"""
Universe and atom groups
========================

The subset of :mod:`mdhelper_tpu_torch.core.universe` the ported analyses
touch: the per-atom :class:`Topology` (masses, charges, types, names,
residue and segment indices, bonds), :class:`Universe` with
:meth:`Universe.from_arrays` and :meth:`Universe.from_files`, the
selection language (:meth:`AtomGroup.select_atoms`), and
:class:`AtomGroup` with its static attributes, residue and segment
groupings, bond-graph fragments, current-frame reductions and
:meth:`AtomGroup.write`.  The universe is host-side metadata only;
analyses stream coordinates from ``universe.trajectory.read_frames``
onto their device.
"""

import fnmatch
import re
from typing import Sequence

import numpy as np

from ..algorithm.utility import find_connected_nodes
from .trajectory import ArrayReader, TrajectoryReader

__all__ = ["Topology", "Universe", "AtomGroup"]


class Topology:
    """Static per-atom attributes.

    All arrays are optional; the defaults are those of the JAX package:
    unit masses, zero charges, type and name ``"X"``, one residue per
    atom (``resids`` one more than ``resindices``), resname ``"UNK"``,
    one segment ``"SYSTEM"`` and no bonds.
    """

    def __init__(
        self,
        n_atoms: int,
        *,
        masses: np.ndarray = None,
        charges: np.ndarray = None,
        types: Sequence[str] = None,
        names: Sequence[str] = None,
        resindices: np.ndarray = None,
        segindices: np.ndarray = None,
        resids: np.ndarray = None,
        resnames: Sequence[str] = None,
        segids: Sequence[str] = None,
        bonds: np.ndarray = None,
    ):
        self.n_atoms = int(n_atoms)

        def _arr(value, default, dtype):
            if value is None:
                return default
            out = np.asarray(value, dtype=dtype)
            if len(out) != self.n_atoms:
                raise ValueError(
                    "Topology attribute length does not match n_atoms."
                )
            return out

        def _labels(value, default):
            return _arr(value, np.array([default] * n_atoms, dtype=object),
                        object)

        self.masses = _arr(masses, np.ones(n_atoms), np.float64)
        self.charges = _arr(charges, np.zeros(n_atoms), np.float64)
        self.types = _labels(types, "X")
        self.names = _labels(names, "X")
        self.resindices = _arr(resindices, np.arange(n_atoms), np.int64)
        self.segindices = _arr(segindices, np.zeros(n_atoms, dtype=int),
                               np.int64)
        self.resids = _arr(resids, self.resindices + 1, np.int64)
        self.resnames = _labels(resnames, "UNK")
        self.segids = _labels(segids, "SYSTEM")
        self.bonds = (
            np.empty((0, 2), dtype=np.int64)
            if bonds is None
            else np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
        )

    @property
    def n_residues(self) -> int:
        return len(np.unique(self.resindices))

    @property
    def n_segments(self) -> int:
        return len(np.unique(self.segindices))


class Universe:
    """Topology + trajectory pair.

    Parameters
    ----------
    topology : :class:`Topology`
    trajectory : :class:`~mdhelper_tpu_torch.core.trajectory.TrajectoryReader`

    Use :meth:`Universe.from_arrays` for quick in-memory construction.
    """

    def __init__(self, topology: Topology, trajectory: TrajectoryReader):
        if topology.n_atoms != trajectory.n_atoms:
            raise ValueError(
                f"Topology has {topology.n_atoms} atoms but the "
                f"trajectory has {trajectory.n_atoms}."
            )
        self._topology = topology
        self.trajectory = trajectory
        self.trajectory[0]  # load the first frame

    @classmethod
    def from_arrays(
        cls,
        positions,
        dimensions=None,
        *,
        dt: float = 1.0,
        times: np.ndarray = None,
        velocities: np.ndarray = None,
        forces: np.ndarray = None,
        **topology_attrs,
    ) -> "Universe":
        """A universe over in-memory ``(n_frames, n_atoms, 3)`` (or one
        ``(n_atoms, 3)`` frame's) positions, with optional per-frame
        `times`, `velocities` and `forces`, and the :class:`Topology`
        attributes given as keywords (``masses=``, ``resindices=``,
        ``bonds=``, ...).  float32 positions stay float32 (the stream
        dtype), as :class:`ArrayReader` keeps them."""

        positions = np.asarray(positions)
        if positions.ndim == 2:
            positions = positions[None]
        reader = ArrayReader(
            positions, dimensions, dt=dt, times=times,
            velocities=velocities, forces=forces,
        )
        return cls(Topology(positions.shape[1], **topology_attrs), reader)

    def guess_bonds(self, **kwargs) -> np.ndarray:
        """Fill the topology's bonds by the distance criterion
        (:func:`mdhelper_tpu_torch.algorithm.topology.guess_bonds`) on the
        CURRENT frame, using atom names as element labels — for
        formats without connectivity (PDB sans CONECT, GRO, XYZ,
        LAMMPS dumps).  Returns the guessed pairs and stores them on
        the topology so the bonded/hydrogen-bond analyses see them."""

        from ..algorithm.topology import guess_bonds

        labels = self._topology.names
        if all(str(n) == "X" for n in labels):
            labels = self._topology.types
        bonds = guess_bonds(
            labels,
            self.trajectory.ts.positions,
            self.dimensions,
            **kwargs,
        )
        self._topology.bonds = bonds
        return bonds

    @classmethod
    def from_files(
        cls,
        topology: str,
        trajectory: str = None,
        **reader_kwargs,
    ) -> "Universe":
        """Build a Universe from file paths — the MDAnalysis-style
        two-argument construction the reference's users write
        (``mda.Universe(psf, dcd)``).

        Parameters
        ----------
        topology : `str`
            Topology file: ``.psf``, ``.pdb``, ``.gro``, LAMMPS
            ``.data``, GROMACS ``.top``/``.itp`` or AMBER
            ``.prmtop``/``.parm7``
            (:mod:`mdhelper_tpu_torch.io.topology_files`).  PDB/GRO files
            also carry coordinates, which become a one-frame
            trajectory when `trajectory` is omitted.
        trajectory : `str`, optional
            Trajectory file: ``.dcd``, ``.xtc``, ``.trr``,
            ``.nc``/``.ncdf``, ``.npz``, LAMMPS
            ``.lammpstrj``/``.dump`` (+ ``.gz``), multi-MODEL
            ``.pdb``, ``.gro`` or ``.xyz``
            (:func:`~mdhelper_tpu_torch.core.trajectory.open_trajectory`).
        **reader_kwargs
            Forwarded to the trajectory reader (e.g. ``dt=...``).
        """

        from ..io.topology_files import read_topology_file
        from .trajectory import open_trajectory

        if topology.lower().endswith((".xyz", ".xyz.gz")):
            # XYZ carries coordinates + element symbols only.
            from ..io.topology_files import _guess_masses
            from .trajectory import XYZReader

            reader = XYZReader(topology)
            top = Topology(
                reader.n_atoms,
                types=reader.symbols,
                names=reader.symbols,
                masses=_guess_masses(reader.symbols),
            )
            if trajectory is not None:
                reader = open_trajectory(trajectory, **reader_kwargs)
            return cls(top, reader)

        parsed = dict(read_topology_file(topology))
        n_atoms = parsed.pop("n_atoms")
        positions = parsed.pop("positions", None)
        frames = parsed.pop("trajectory", None)
        dimensions = parsed.pop("dimensions", None)
        top = Topology(n_atoms, **parsed)

        if trajectory is not None:
            reader = open_trajectory(trajectory, **reader_kwargs)
        elif topology.lower().endswith(".gro"):
            # Concatenated multi-frame .gro files (gmx trjconv) carry
            # a whole trajectory; route through GROReader so frames
            # past the first are not discarded.
            reader = open_trajectory(topology, **reader_kwargs)
        elif frames is not None or positions is not None:
            # Multi-MODEL PDBs carry a whole trajectory; single-frame
            # files become a one-frame trajectory.
            reader = ArrayReader(
                frames if frames is not None else positions[None],
                None if dimensions is None else dimensions,
            )
        else:
            raise ValueError(
                f"'{topology}' carries no coordinates; provide a "
                "trajectory file."
            )
        return cls(top, reader)

    @property
    def atoms(self) -> "AtomGroup":
        return AtomGroup(self, np.arange(self._topology.n_atoms))

    @property
    def dimensions(self) -> np.ndarray:
        return self.trajectory.ts.dimensions

    @property
    def bonds(self) -> np.ndarray:
        return self._topology.bonds

    @property
    def residues(self):
        return self.atoms.residues

    @property
    def segments(self):
        return self.atoms.segments

    def select_atoms(self, selection: str) -> "AtomGroup":
        return self.atoms.select_atoms(selection)


class _SelectionParser:
    """Recursive-descent parser for the atom-selection language (see
    :meth:`AtomGroup.select_atoms` for the grammar).  Standing in for
    the MDAnalysis selection engine; a copy of the JAX package's."""

    _COMPARISONS = {
        "<": np.less,
        "<=": np.less_equal,
        ">": np.greater,
        ">=": np.greater_equal,
        "==": np.equal,
        "!=": np.not_equal,
    }
    _KEYWORDS = frozenset(
        ("all", "none", "charged", "type", "name", "resname",
         "segid", "resid", "index", "mass", "charge", "and", "or",
         "not", "around", "prop", "point", "sphzone", "byres",
         "bysegment", "same")
    )
    _LABEL_ATTRS = {
        "type": "types",
        "name": "names",
        "resname": "resnames",
        "segid": "segids",
    }
    _TOKEN = re.compile(r"\(|\)|<=|>=|==|!=|<|>|[^\s()<>=!]+")
    _NUMBER = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")

    def __init__(self, selection: str, group: "AtomGroup"):
        self._tokens = self._TOKEN.findall(selection)
        self._pos = 0
        self._group = group
        self._n = len(group.ix)
        self._selection = selection

    # -- token stream ----------------------------------------------------
    def _peek(self):
        return (
            self._tokens[self._pos]
            if self._pos < len(self._tokens)
            else None
        )

    def _next(self):
        token = self._peek()
        self._pos += 1
        return token

    def _error(self, message: str):
        raise ValueError(
            f"Invalid selection '{self._selection}': {message}"
        )

    # -- grammar ---------------------------------------------------------
    def parse(self) -> np.ndarray:
        if not self._tokens:
            self._error("empty selection.")
        mask = self._or_expr()
        if self._peek() is not None:
            self._error(f"unexpected token '{self._peek()}'.")
        return mask

    def _or_expr(self) -> np.ndarray:
        mask = self._and_expr()
        while self._peek() == "or":
            self._next()
            mask = mask | self._and_expr()
        return mask

    def _and_expr(self) -> np.ndarray:
        mask = self._not_expr()
        while self._peek() == "and":
            self._next()
            mask = mask & self._not_expr()
        return mask

    def _not_expr(self) -> np.ndarray:
        token = self._peek()
        if token == "not":
            self._next()
            return ~self._not_expr()
        if token == "(":
            self._next()
            mask = self._or_expr()
            if self._next() != ")":
                self._error("unbalanced parentheses.")
            return mask
        return self._term()

    def _term(self) -> np.ndarray:
        keyword = self._next()
        group = self._group
        if keyword == "all":
            return np.ones(self._n, dtype=bool)
        if keyword == "none":
            return np.zeros(self._n, dtype=bool)
        if keyword == "charged":
            return group.charges != 0
        if keyword == "around":
            # around CUTOFF <sel>: atoms within CUTOFF Angstrom of
            # ANY reference atom, excluding the reference itself
            # (MDAnalysis semantics).  Evaluated at the CURRENT
            # trajectory frame with minimum-image distances for
            # orthorhombic boxes; `<sel>` binds one unit — use
            # parentheses for compound references.
            number = self._next()
            if number is None or not self._NUMBER.match(number):
                self._error("'around' expects a cutoff distance.")
            cutoff = float(number)
            inner = self._not_expr()
            return self._around(cutoff, inner)
        if keyword == "same":
            # same ATTR as <sel>: atoms sharing any matched atom's
            # value of ATTR (MDAnalysis semantics; "byres" is the
            # resindex special case).
            attr = self._next()
            label_attrs = dict(self._LABEL_ATTRS)
            numeric = ("mass", "charge", "resid", "index")
            if attr not in label_attrs and attr not in numeric:
                self._error(
                    "'same' expects one of "
                    f"{sorted((*label_attrs, *numeric))}."
                )
            if self._next() != "as":
                self._error("'same ATTR' must be followed by 'as'.")
            inner = self._not_expr()
            values = (
                getattr(group, label_attrs[attr])
                if attr in label_attrs
                else group._selection_values(attr)
            )
            values = np.asarray(values)
            return np.isin(values, np.unique(values[inner]))
        if keyword in ("byres", "bysegment"):
            # byres <sel> / bysegment <sel>: expand the matched atoms
            # to every atom sharing their residue/segment
            # (MDAnalysis semantics).
            inner = self._not_expr()
            labels = (
                self._group.resindices
                if keyword == "byres"
                else self._group.segindices
            )
            return np.isin(labels, np.unique(labels[inner]))
        if keyword == "prop":
            # prop [abs] x|y|z OP NUMBER: positional comparison at
            # the current frame (MDAnalysis semantics).
            token = self._next()
            use_abs = token == "abs"
            if use_abs:
                token = self._next()
            if token not in ("x", "y", "z"):
                self._error(
                    "'prop' expects x, y or z (optionally "
                    "preceded by 'abs')."
                )
            axis = ord(token) - 120
            op = self._next()
            if op not in self._COMPARISONS:
                self._error("'prop' requires a comparison operator.")
            number = self._next()
            if number is None or not self._NUMBER.match(number):
                self._error(f"'prop {token} {op}' expects a number.")
            values = np.asarray(
                self._group.positions, dtype=np.float64
            )[:, axis]
            if use_abs:
                values = np.abs(values)
            return self._COMPARISONS[op](values, float(number))
        if keyword == "point":
            # point X Y Z CUTOFF: atoms within CUTOFF of the point.
            numbers = []
            for _ in range(4):
                token = self._next()
                if token is None or not self._NUMBER.match(token):
                    self._error("'point' expects x y z cutoff.")
                numbers.append(float(token))
            return self._within_point(
                np.asarray(numbers[:3]), numbers[3]
            )
        if keyword == "sphzone":
            # sphzone CUTOFF <sel>: atoms within CUTOFF of the
            # center of geometry of <sel> (inclusive — unlike
            # 'around', the reference atoms themselves may match).
            number = self._next()
            if number is None or not self._NUMBER.match(number):
                self._error("'sphzone' expects a cutoff distance.")
            cutoff = float(number)
            inner = self._not_expr()
            if not inner.any():
                return np.zeros(self._n, dtype=bool)
            center = np.asarray(
                self._group.positions, dtype=np.float64
            )[inner].mean(axis=0)
            return self._within_point(center, cutoff)
        if keyword in self._LABEL_ATTRS:
            values = getattr(group, self._LABEL_ATTRS[keyword])
            labels = []
            while (
                self._peek() is not None
                and self._peek() not in self._KEYWORDS
                and self._peek() not in "()<>"
                and self._peek() not in self._COMPARISONS
            ):
                labels.append(self._next())
            if not labels:
                self._error(f"'{keyword}' expects one or more labels.")
            # fnmatch globbing (MDAnalysis semantics): "name H*"
            # matches H, H1, HW1, ...; plain labels match literally.
            plain = [l for l in labels if not any(c in l for c in "*?[")]
            mask = (
                np.isin(values, plain)
                if plain
                else np.zeros(self._n, dtype=bool)
            )
            patterns = [l for l in labels if l not in plain]
            if patterns:
                unique = np.unique(np.asarray(values, dtype=object))
                matched = {
                    label
                    for pattern in patterns
                    for label in fnmatch.filter(unique, pattern)
                }
                if matched:
                    mask = mask | np.isin(values, list(matched))
            return mask
        if keyword in ("mass", "charge", "resid", "index"):
            op = self._peek()
            if op in self._COMPARISONS:
                self._next()
                number = self._next()
                if number is None or not self._NUMBER.match(number):
                    self._error(
                        f"'{keyword} {op}' expects a number."
                    )
                values = group._selection_values(keyword)
                return self._COMPARISONS[op](values, float(number))
            if keyword in ("mass", "charge"):
                self._error(
                    f"'{keyword}' requires a comparison operator."
                )
            # resid/index with explicit values or inclusive i:j ranges.
            values = group._selection_values(keyword)
            mask = np.zeros(self._n, dtype=bool)
            seen = False
            while self._peek() is not None and re.fullmatch(
                r"-?\d+(:-?\d+)?", self._peek()
            ):
                arg = self._next()
                seen = True
                if ":" in arg:
                    lo, hi = (int(x) for x in arg.split(":"))
                    mask |= (values >= lo) & (values <= hi)
                else:
                    mask |= values == int(arg)
            if not seen:
                self._error(
                    f"'{keyword}' expects indices or i:j ranges."
                )
            return mask
        self._error(f"unsupported selection term '{keyword}'.")

    def _periodic_box(self):
        """The current orthorhombic box lengths (float64, (3,)) when
        minimum-image distances apply, else ``None`` — the shared
        periodicity convention of every geometric selection term."""

        dims = self._group.dimensions
        if (
            dims is not None
            and np.all(np.asarray(dims[:3]) > 0)
            and np.allclose(dims[3:6], 90.0)
        ):
            return np.asarray(dims[:3], dtype=np.float64)
        return None

    def _around(self, cutoff: float, inner: np.ndarray) -> np.ndarray:
        """Atoms of the group within `cutoff` of any `inner` atom,
        excluding `inner` — a cKDTree ball query, periodic when the
        current box is orthorhombic (MDAnalysis applies the same
        minimum-image convention; triclinic boxes fall back to
        non-periodic distances, documented in select_atoms)."""

        from scipy.spatial import cKDTree

        if not inner.any():
            return np.zeros(self._n, dtype=bool)
        group = self._group
        positions = np.asarray(group.positions, dtype=np.float64)
        box = self._periodic_box()
        if box is not None:
            positions = positions % box
            # Guard the half-open [0, box) domain cKDTree requires
            # (x % box can land exactly on box for tiny negatives).
            positions[positions >= box] = 0.0
        tree = cKDTree(positions[inner], boxsize=box)
        dist, _ = tree.query(
            positions, k=1, distance_upper_bound=cutoff
        )
        return (dist <= cutoff) & ~inner

    def _within_point(
        self, point: np.ndarray, cutoff: float
    ) -> np.ndarray:
        """Atoms of the group within `cutoff` of `point` — minimum-
        image for orthorhombic boxes, plain Euclidean otherwise
        (same convention as :meth:`_around`)."""

        positions = np.asarray(
            self._group.positions, dtype=np.float64
        )
        delta = positions - np.asarray(point, dtype=np.float64)
        box = self._periodic_box()
        if box is not None:
            delta -= box * np.round(delta / box)
        return (delta**2).sum(axis=1) <= cutoff**2


class _SubGroup:
    """A residue or segment view: exposes ``.atoms``."""

    __slots__ = ("atoms", "index")

    def __init__(self, atoms: "AtomGroup", index: int):
        self.atoms = atoms
        self.index = index


class AtomGroup:
    """An ordered set of atoms in a :class:`Universe`."""

    def __init__(self, universe: Universe, indices):
        self.universe = universe
        self._ix = np.asarray(indices, dtype=np.int64)

    # -- identity ----------------------------------------------------------
    @property
    def ix(self) -> np.ndarray:
        return self._ix

    indices = ix

    @property
    def n_atoms(self) -> int:
        return len(self._ix)

    def __len__(self) -> int:
        return len(self._ix)

    def __getitem__(self, item) -> "AtomGroup":
        """Sub-group by slice, integer index or array, or boolean
        mask (``u.atoms[0::2]``)."""

        return AtomGroup(self.universe, np.atleast_1d(self._ix[item]))

    def __add__(self, other: "AtomGroup") -> "AtomGroup":
        return AtomGroup(self.universe, np.concatenate((self._ix, other._ix)))

    def union(self, other: "AtomGroup") -> "AtomGroup":
        return AtomGroup(
            self.universe, np.unique(np.concatenate((self._ix, other._ix)))
        )

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AtomGroup)
            and self.universe is other.universe
            and np.array_equal(self._ix, other._ix)
        )

    def __hash__(self):
        return hash((id(self.universe), self._ix.tobytes()))

    def __repr__(self) -> str:
        return f"<AtomGroup with {self.n_atoms} atoms>"

    # -- static attributes -------------------------------------------------
    @property
    def masses(self) -> np.ndarray:
        return self.universe._topology.masses[self._ix]

    @property
    def charges(self) -> np.ndarray:
        return self.universe._topology.charges[self._ix]

    @property
    def types(self) -> np.ndarray:
        return self.universe._topology.types[self._ix]

    @property
    def names(self) -> np.ndarray:
        return self.universe._topology.names[self._ix]

    @property
    def resnames(self) -> np.ndarray:
        return self.universe._topology.resnames[self._ix]

    @property
    def segids(self) -> np.ndarray:
        return self.universe._topology.segids[self._ix]

    @property
    def resindices(self) -> np.ndarray:
        return self.universe._topology.resindices[self._ix]

    @property
    def segindices(self) -> np.ndarray:
        return self.universe._topology.segindices[self._ix]

    @property
    def dimensions(self) -> np.ndarray:
        return self.universe.dimensions

    # -- dynamic attributes ------------------------------------------------
    @property
    def positions(self) -> np.ndarray:
        return self.universe.trajectory.ts.positions[self._ix]

    # -- groupings ---------------------------------------------------------
    def _grouped(self, labels: np.ndarray) -> list:
        """One :class:`_SubGroup` per distinct label, in ascending label
        order, each holding its atoms in group order."""

        order = np.argsort(labels, kind="stable")
        boundaries = np.flatnonzero(np.diff(labels[order])) + 1
        return [
            _SubGroup(AtomGroup(self.universe, self._ix[g]), i)
            for i, g in enumerate(np.split(order, boundaries))
        ]

    @property
    def residues(self) -> list:
        return self._grouped(self.resindices)

    @property
    def segments(self) -> list:
        return self._grouped(self.segindices)

    @property
    def n_residues(self) -> int:
        return len(np.unique(self.resindices))

    @property
    def n_segments(self) -> int:
        return len(np.unique(self.segindices))

    @property
    def bonds(self) -> np.ndarray:
        """Bonds (absolute indices) with both endpoints in this group."""

        bonds = self.universe._topology.bonds
        if not len(bonds):
            return bonds
        member = np.zeros(self.universe._topology.n_atoms, dtype=bool)
        member[self._ix] = True
        return bonds[member[bonds[:, 0]] & member[bonds[:, 1]]]

    @property
    def fragments(self) -> list:
        """Connected components of the bond graph restricted to this
        group, each as a group of its atoms in ascending index order."""

        adjacency = {int(i): [] for i in self._ix}
        for a, b in self.bonds:
            adjacency[int(a)].append(int(b))
            adjacency[int(b)].append(int(a))
        return [
            AtomGroup(self.universe, np.array(sorted(component)))
            for component in find_connected_nodes(adjacency)
        ]

    # -- reductions --------------------------------------------------------
    def center_of_mass(self) -> np.ndarray:
        masses = self.masses
        return (masses[:, None] * self.positions).sum(axis=0) / masses.sum()

    def total_charge(self) -> float:
        return float(self.charges.sum())

    def total_mass(self) -> float:
        return float(self.masses.sum())

    def center_of_geometry(self) -> np.ndarray:
        # float64, as the JAX package's float64 frames give it.
        return np.asarray(self.positions, dtype=np.float64).mean(axis=0)

    def radius_of_gyration(self) -> float:
        """Mass-weighted radius of gyration of the current frame (raw
        coordinates)."""

        masses = self.masses
        delta = self.positions - self.center_of_mass()
        return float(np.sqrt(
            (masses * (delta * delta).sum(axis=1)).sum() / masses.sum()
        ))

    # -- selection -------------------------------------------------------
    def select_atoms(self, selection: str) -> "AtomGroup":
        """Select atoms with an MDAnalysis-style boolean expression.

        Grammar (recursive descent; see :class:`_SelectionParser`)::

            expr     := and_expr ( "or" and_expr )*
            and_expr := not_expr ( "and" not_expr )*
            not_expr := "not" not_expr | "(" expr ")" | term
            term     := "all" | "none" | "charged"
                      | ("type" | "name" | "resname" | "segid") WORD+
                      | ("resid" | "index") (INT | INT:INT)+
                      | PROP OP NUMBER        # numeric comparison
                      | "prop" ["abs"] AXIS OP NUMBER  # positional
                      | "around" NUMBER not_expr
                      | "sphzone" NUMBER not_expr
                      | "point" NUMBER NUMBER NUMBER NUMBER
                      | ("byres" | "bysegment") not_expr
                      | "same" ATTR "as" not_expr
            PROP     := "mass" | "charge" | "resid" | "index"
            AXIS     := "x" | "y" | "z"
            OP       := "<" | "<=" | ">" | ">=" | "==" | "!="

        Label terms support :mod:`fnmatch` globbing (MDAnalysis
        semantics): ``"name H*"`` matches H, H1, HW1, ...; ``?``
        and ``[seq]`` work too; labels without glob characters
        match literally.  Grammar keywords (``prop``, ``point``,
        ``around``, ...) are reserved words inside label lists; a
        label that collides with one can be matched with a
        single-character glob class (``"name [p]oint"``).

        Examples: ``"type A B"``, ``"not name H*"``, ``"charge < 0"``,
        ``"(type A or type B) and not resid 1:10"``,
        ``"mass > 12 and charged"``.  ``resid i:j`` ranges are
        inclusive on both ends (MDAnalysis convention).

        ``around CUTOFF sel`` selects atoms within ``CUTOFF``
        Angstrom of any atom matched by ``sel``, excluding ``sel``
        itself (MDAnalysis ``around`` semantics), evaluated at the
        current trajectory frame.  Distances are minimum-image for
        orthorhombic boxes; triclinic (or absent) boxes use plain
        Euclidean distances.  ``sel`` binds one ``not_expr`` unit —
        parenthesise compound references:
        ``"around 3.5 (resname SOL and name OW)"``.

        Positional terms (evaluated at the current frame, same
        periodicity convention as ``around``):
        ``prop z < 10`` / ``prop abs z < 5`` compare one coordinate
        (slab selections); ``point X Y Z CUTOFF`` selects within
        ``CUTOFF`` of a fixed point; ``sphzone CUTOFF sel`` selects
        within ``CUTOFF`` of the center of geometry of ``sel``
        (inclusive of ``sel`` itself, unlike ``around``).

        ``byres sel`` / ``bysegment sel`` expand the matched atoms to
        every atom sharing their residue / segment — e.g.
        ``"byres around 3.5 type NA"`` selects whole solvation-shell
        molecules.  ``same ATTR as sel`` generalizes this to any
        attribute (``type``/``name``/``resname``/``segid``/``resid``/
        ``mass``/``charge``/``index``): ``"same resname as index 0"``.
        """

        parser = _SelectionParser(selection, self)
        mask = parser.parse()
        return AtomGroup(self.universe, self._ix[mask])

    def _selection_values(self, prop: str) -> np.ndarray:
        """Per-atom numeric values backing a selection property."""

        if prop == "mass":
            return self.masses
        if prop == "charge":
            return self.charges
        if prop == "resid":
            return self.universe._topology.resids[self._ix]
        if prop == "index":
            return self._ix
        raise ValueError(f"Unknown selection property: '{prop}'.")

    def write(self, filename: str) -> None:
        """Write the group at the CURRENT trajectory frame to a
        structure file — dispatched by extension: ``.pdb``, ``.gro``
        or ``.xyz`` (:mod:`mdhelper_tpu_torch.io.structure_writers`).  The
        MDAnalysis ``u.atoms.write(...)`` convenience the reference's
        users rely on."""

        from ..io import structure_writers as sw

        lower = filename.lower()
        topology = self.universe._topology
        if lower.endswith(".pdb"):
            # elements omitted: force-field type strings ("OW",
            # "CT") are not element symbols; write_pdb's
            # name-derived guess is safer for external readers.
            sw.write_pdb(
                filename,
                self.positions,
                names=self.names,
                resnames=self.resnames,
                resids=topology.resids[self._ix],
                segids=self.segids,
                dimensions=self.dimensions,
            )
        elif lower.endswith(".gro"):
            sw.write_gro(
                filename,
                self.positions,
                names=self.names,
                resnames=self.resnames,
                resids=topology.resids[self._ix],
                dimensions=self.dimensions,
            )
        elif lower.endswith(".xyz"):
            sw.write_xyz(filename, self.positions, symbols=self.types)
        else:
            raise ValueError(
                f"Unsupported structure format: '{filename}' "
                "(supported: .pdb, .gro, .xyz)."
            )
