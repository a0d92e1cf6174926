"""
Topology file parsers
=====================

Dependency-free parsers for the common topology formats, copied from
:mod:`mdhelper_tpu.io.topology_files` (numpy only):

- **PSF** (CHARMM/X-PLOR/NAMD): atoms (segment, resid, resname, name,
  type, charge, mass) and bonds;
- **PDB**: ``ATOM``/``HETATM`` records (+ ``CONECT`` bonds,
  ``CRYST1`` box) — also yields coordinates;
- **GRO**: fixed-column GROMACS coordinate file — topology naming plus
  nm coordinates and box;
- **TOP/ITP**: GROMACS topologies — moleculetypes, atoms (types,
  charges, masses), bonds/settles and the ``[ molecules ]``
  composition, across ``#include``\\ s with ``#ifdef`` handling.

Each parser returns a plain dict of arrays consumed by
:meth:`mdhelper_tpu_torch.core.universe.Universe.from_files`.
"""

import numpy as np

__all__ = [
    "read_psf",
    "read_pdb",
    "read_gro",
    "read_lammps_data",
    "read_gmx_top",
    "read_topology_file",
]


def _object_array(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def read_psf(filename: str) -> dict:
    """Parse a PSF topology (CHARMM space-delimited and X-PLOR/NAMD
    variants; EXT wide-column files parse identically because fields
    are taken by whitespace split)."""

    with open(filename) as fh:
        lines = fh.read().splitlines()
    if not lines or "PSF" not in lines[0]:
        raise ValueError(f"'{filename}' is not a PSF file.")

    def section(tag):
        for i, line in enumerate(lines):
            if tag in line:
                count = int(line.split()[0])
                return i, count
        return None, 0

    i, n_atoms = section("!NATOM")
    if i is None:
        raise ValueError(f"'{filename}' has no !NATOM section.")
    segids, resids, resnames, names, types = [], [], [], [], []
    charges, masses = [], []
    row = i + 1
    parsed = 0
    while parsed < n_atoms:
        fields = lines[row].split()
        row += 1
        if not fields:
            continue
        # id segid resid resname name type charge mass [imove ...]
        segids.append(fields[1])
        resids.append(int(fields[2]))
        resnames.append(fields[3])
        names.append(fields[4])
        types.append(fields[5])
        charges.append(float(fields[6]))
        masses.append(float(fields[7]))
        parsed += 1

    bonds = []
    i, n_bonds = section("!NBOND")
    if i is not None:
        row = i + 1
        flat = []
        while len(flat) < 2 * n_bonds and row < len(lines):
            flat.extend(int(x) for x in lines[row].split())
            row += 1
        bonds = (
            np.asarray(flat[: 2 * n_bonds], dtype=np.int64).reshape(
                -1, 2
            )
            - 1  # PSF is 1-based
        )

    # Residue/segment indices factorized by first occurrence
    # (np.unique would reorder by sort).
    segindices = _factorize(segids)
    resindices = _factorize(
        [f"{s}|{r}" for s, r in zip(segids, resids)]
    )

    return {
        "n_atoms": n_atoms,
        "names": _object_array(names),
        "types": _object_array(types),
        "charges": np.asarray(charges),
        "masses": np.asarray(masses),
        "resids": np.asarray(resids, dtype=np.int64),
        "resnames": _object_array(resnames),
        "resindices": resindices,
        "segindices": segindices,
        "segids": _object_array(segids),
        "bonds": np.asarray(bonds, dtype=np.int64).reshape(-1, 2),
    }


#: Standard atomic masses for the elements that appear in
#: biomolecular/materials topologies (MDAnalysis-style mass guessing
#: for formats that do not store masses).
_ELEMENT_MASSES = {
    "H": 1.008, "D": 2.014, "HE": 4.0026, "LI": 6.941, "B": 10.811,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998,
    "NE": 20.180, "NA": 22.990, "MG": 24.305, "AL": 26.982,
    "SI": 28.086, "P": 30.974, "S": 32.065, "CL": 35.453,
    "AR": 39.948, "K": 39.098, "CA": 40.078, "FE": 55.845,
    "ZN": 65.38, "BR": 79.904, "RB": 85.468, "I": 126.90,
    "CS": 132.91,
}


_ORGANIC = frozenset("HCNOSP")


def _guess_masses(symbols, *, from_names: bool = False) -> np.ndarray:
    """Guess per-atom masses from element symbols (or, with
    ``from_names``, atom names — where a leading organic element wins
    over two-letter collisions: ``CA`` is an alpha-carbon, not
    calcium, in name-only formats)."""

    masses = np.zeros(len(symbols))
    for i, symbol in enumerate(symbols):
        letters = "".join(
            c for c in str(symbol).upper() if c.isalpha()
        )
        if from_names and letters[:1] in _ORGANIC:
            masses[i] = _ELEMENT_MASSES[letters[:1]]
        else:
            masses[i] = _ELEMENT_MASSES.get(
                letters[:2], _ELEMENT_MASSES.get(letters[:1], 0.0)
            )
    return masses


def _factorize(keys) -> np.ndarray:
    seen = {}
    out = np.empty(len(keys), dtype=np.int64)
    for i, key in enumerate(keys):
        out[i] = seen.setdefault(key, len(seen))
    return out


def read_pdb(filename: str) -> dict:
    """Parse PDB ``ATOM``/``HETATM`` records (fixed columns), CONECT
    bonds and the CRYST1 box.  Returns topology arrays plus
    ``positions`` (Angstrom) and ``dimensions``.  Multi-``MODEL``
    files yield a ``(n_models, N, 3)`` ``trajectory`` array (the
    MDAnalysis multi-frame PDB convention); topology comes from the
    first model."""

    names, resnames, chains, resids, elements = [], [], [], [], []
    coords, serials = [], []
    bonds = []
    dimensions = None
    frames = []
    in_later_model = False
    with open(filename) as fh:
        for line in fh:
            record = line[:6]
            if record in ("ATOM  ", "HETATM"):
                xyz = (
                    float(line[30:38]),
                    float(line[38:46]),
                    float(line[46:54]),
                )
                if in_later_model:
                    frames[-1].append(xyz)
                    continue
                serials.append(line[6:11].strip())
                names.append(line[12:16].strip())
                resnames.append(line[17:21].strip())
                chains.append(line[21].strip() or "A")
                resids.append(int(line[22:26]))
                coords.append(xyz)
                element = line[76:78].strip() if len(line) > 76 else ""
                elements.append(element or line[12:16].strip()[:1])
            elif record == "MODEL ":
                if coords:
                    in_later_model = True
                    frames.append([])
            elif record == "CONECT":
                fields = line.split()[1:]
                if len(fields) >= 2:
                    a = int(fields[0])
                    for b in fields[1:]:
                        bonds.append((a, int(b)))
            elif record == "CRYST1":
                dimensions = np.array(
                    [
                        float(line[6:15]),
                        float(line[15:24]),
                        float(line[24:33]),
                        float(line[33:40]),
                        float(line[40:47]),
                        float(line[47:54]),
                    ]
                )
    if not coords:
        raise ValueError(f"'{filename}' contains no ATOM records.")
    frames = [f for f in frames if f]
    for f, frame in enumerate(frames):
        if len(frame) != len(coords):
            raise ValueError(
                f"MODEL {f + 2} has {len(frame)} atoms; expected "
                f"{len(coords)}."
            )

    serial_to_index = {s: i for i, s in enumerate(serials)}
    bond_idx = []
    seen = set()
    for a, b in bonds:
        i = serial_to_index.get(str(a))
        j = serial_to_index.get(str(b))
        if i is None or j is None:
            continue
        key = (min(i, j), max(i, j))
        if key not in seen:
            seen.add(key)
            bond_idx.append(key)

    res_keys = [f"{c}|{r}" for c, r in zip(chains, resids)]
    return {
        "n_atoms": len(coords),
        "names": _object_array(names),
        "types": _object_array(elements),
        "masses": _guess_masses(elements),
        "resids": np.asarray(resids, dtype=np.int64),
        "resnames": _object_array(resnames),
        "resindices": _factorize(res_keys),
        "segindices": _factorize(chains),
        "segids": _object_array(
            [c if c else "SYSTEM" for c in chains]
        ),
        "bonds": np.asarray(bond_idx, dtype=np.int64).reshape(-1, 2),
        "positions": np.asarray(coords),
        "trajectory": (
            np.asarray([coords] + frames) if frames else None
        ),
        "dimensions": dimensions,
    }


def parse_gro_box(line: str):
    """``(lx ly lz [90 x 3])`` dimensions (Angstrom) from a .gro box
    line — 3 fields for rectangular boxes, 9 (``v1x v2y v3z v1y v1z
    v2x v2z v3x v3y``) for triclinic; ``None`` if unparseable."""

    box_fields = [float(x) for x in line.split()]
    if len(box_fields) == 3 and all(v >= 0 for v in box_fields):
        return np.array(
            [*(10.0 * np.asarray(box_fields)), 90.0, 90.0, 90.0]
        )
    if len(box_fields) == 9:
        v = box_fields
        matrix = 10.0 * np.array(
            [
                [v[0], v[3], v[4]],
                [v[5], v[1], v[6]],
                [v[7], v[8], v[2]],
            ]
        )
        lengths = np.linalg.norm(matrix, axis=1)

        def angle(x, y):
            return np.degrees(
                np.arccos(
                    np.clip(
                        np.dot(x, y)
                        / (np.linalg.norm(x) * np.linalg.norm(y)),
                        -1,
                        1,
                    )
                )
            )

        return np.array(
            [
                *lengths,
                angle(matrix[1], matrix[2]),
                angle(matrix[0], matrix[2]),
                angle(matrix[0], matrix[1]),
            ]
        )
    return None


def read_gro(filename: str) -> dict:
    """Parse a GROMACS ``.gro`` file (fixed columns, nm).  Returns
    topology arrays plus ``positions``/``dimensions`` converted to
    Angstrom (the package convention, like MDAnalysis)."""

    with open(filename) as fh:
        lines = fh.read().splitlines()
    if len(lines) < 3:
        raise ValueError(f"'{filename}' is too short to be a .gro file.")
    n_atoms = int(lines[1])
    if len(lines) < n_atoms + 3:
        raise ValueError(f"'{filename}' is truncated.")

    resids, resnames, names, coords = [], [], [], []
    for line in lines[2:2 + n_atoms]:
        resids.append(int(line[0:5]))
        resnames.append(line[5:10].strip())
        names.append(line[10:15].strip())
        coords.append(
            (float(line[20:28]), float(line[28:36]), float(line[36:44]))
        )

    dimensions = parse_gro_box(lines[2 + n_atoms])

    res_keys = [f"{r}|{n}" for r, n in zip(resids, resnames)]
    return {
        "n_atoms": n_atoms,
        "names": _object_array(names),
        "types": _object_array(
            [name.rstrip("0123456789") or name for name in names]
        ),
        "resids": np.asarray(resids, dtype=np.int64),
        "resnames": _object_array(resnames),
        "resindices": _factorize(res_keys),
        "masses": _guess_masses(names, from_names=True),
        "positions": 10.0 * np.asarray(coords),
        "dimensions": dimensions,
    }


def read_lammps_data(filename: str) -> dict:
    """Parse a LAMMPS data file (atom_style ``full``, ``charge``,
    ``molecular`` or ``atomic`` — detected from the ``Atoms`` section
    comment or the column count).  The input-side counterpart of
    the JAX package's ``mdhelper_tpu.lammps.topology.write_data``:
    returns per-atom types/charges/
    masses/resindices, bonds, positions and box dimensions."""

    with open(filename) as fh:
        lines = fh.read().splitlines()

    def strip_comment(line):
        return line.split("#", 1)[0].strip()

    counts = {}
    bounds = {}
    tilt = (0.0, 0.0, 0.0)
    section = None
    section_comment = ""
    masses_by_type = {}
    atom_rows, bond_rows = [], []
    header_keys = (
        "atoms", "bonds", "angles", "dihedrals", "impropers",
        "atom types", "bond types", "angle types", "dihedral types",
        "improper types",
    )
    known_sections = (
        "Masses", "Atoms", "Velocities", "Bonds", "Angles",
        "Dihedrals", "Impropers", "Pair Coeffs", "Bond Coeffs",
        "Angle Coeffs", "Dihedral Coeffs", "Improper Coeffs",
    )
    for line in lines[1:]:  # first line is the title
        raw = line.strip()
        bare = strip_comment(line)
        header = next(
            (s for s in known_sections if raw.startswith(s)), None
        )
        if header is not None:
            section = header
            section_comment = (
                raw.split("#", 1)[1].strip() if "#" in raw else ""
            )
            continue
        if not bare:
            continue
        if section is None:
            fields = bare.split()
            matched = False
            for key in header_keys:
                parts = key.split()
                if fields[-len(parts):] == parts and len(fields) == (
                    1 + len(parts)
                ):
                    counts[key] = int(fields[0])
                    matched = True
                    break
            if matched:
                continue
            if len(fields) == 4 and fields[2].endswith("lo"):
                axis = fields[2][0]
                bounds[axis] = (float(fields[0]), float(fields[1]))
            elif fields[-3:] == ["xy", "xz", "yz"]:
                tilt = tuple(float(x) for x in fields[:3])
            continue
        fields = bare.split()
        if section == "Masses":
            masses_by_type[int(fields[0])] = float(fields[1])
        elif section == "Atoms":
            atom_rows.append(fields)
        elif section == "Bonds":
            bond_rows.append(fields)

    if not atom_rows:
        raise ValueError(f"'{filename}' has no Atoms section.")

    style = section_comment if section_comment else None
    n_cols = len(atom_rows[0])
    if style is None:
        # full: id mol type q x y z (7+); molecular: id mol type xyz
        # (6); charge: id type q xyz (6); atomic: id type xyz (5).
        # 6 columns is ambiguous -> prefer charge when the 3rd field
        # is non-integer-valued.
        if n_cols >= 7:
            style = "full"
        elif n_cols == 5:
            style = "atomic"
        else:
            third = float(atom_rows[0][2])
            style = "charge" if third != int(third) else "molecular"

    layouts = {
        "full": ("id", "mol", "type", "q", "x", "y", "z"),
        "molecular": ("id", "mol", "type", "x", "y", "z"),
        "charge": ("id", "type", "q", "x", "y", "z"),
        "atomic": ("id", "type", "x", "y", "z"),
    }
    if style not in layouts:
        raise ValueError(
            f"Unsupported atom_style '{style}' in '{filename}'."
        )
    layout = layouts[style]
    col = {name: i for i, name in enumerate(layout)}

    n_atoms = len(atom_rows)
    ids = np.array([int(r[col["id"]]) for r in atom_rows])
    order = np.argsort(ids, kind="stable")
    atom_rows = [atom_rows[i] for i in order]
    types = np.array([int(r[col["type"]]) for r in atom_rows])
    charges = (
        np.array([float(r[col["q"]]) for r in atom_rows])
        if "q" in col
        else np.zeros(n_atoms)
    )
    mols = (
        np.array([int(r[col["mol"]]) for r in atom_rows])
        if "mol" in col
        else np.arange(n_atoms) + 1
    )
    positions = np.array(
        [
            [float(r[col["x"]]), float(r[col["y"]]), float(r[col["z"]])]
            for r in atom_rows
        ]
    )
    masses = np.array(
        [masses_by_type.get(t, 1.0) for t in types], dtype=float
    )

    id_to_index = {int(i): k for k, i in enumerate(ids[order])}
    bonds = np.array(
        [
            [id_to_index[int(r[2])], id_to_index[int(r[3])]]
            for r in bond_rows
        ],
        dtype=np.int64,
    ).reshape(-1, 2)

    dimensions = None
    if all(a in bounds for a in "xyz"):
        lo = np.array([bounds[a][0] for a in "xyz"])
        hi = np.array([bounds[a][1] for a in "xyz"])
        lx, ly, lz = hi - lo
        xy, xz, yz = tilt
        h = np.array([[lx, 0, 0], [xy, ly, 0], [xz, yz, lz]])
        lengths = np.linalg.norm(h, axis=1)

        def angle(u, v):
            return np.degrees(
                np.arccos(
                    np.clip(
                        np.dot(u, v)
                        / (np.linalg.norm(u) * np.linalg.norm(v)),
                        -1,
                        1,
                    )
                )
            )

        dimensions = np.array(
            [
                *lengths,
                angle(h[1], h[2]),
                angle(h[0], h[2]),
                angle(h[0], h[1]),
            ]
        )

    return {
        "n_atoms": n_atoms,
        "types": _object_array([str(t) for t in types]),
        "names": _object_array([str(t) for t in types]),
        "charges": charges,
        "masses": masses,
        "resids": mols.astype(np.int64),
        "resindices": _factorize([int(m) for m in mols]),
        "bonds": bonds,
        "positions": positions,
        "dimensions": dimensions,
    }


def _gmx_preprocess(filename, defines, _depth=0):
    """Yield cpp-preprocessed logical lines of a GROMACS topology:
    ``#include`` expansion (relative to the including file),
    ``#define`` collection and ``#ifdef``/``#ifndef``/``#else``/
    ``#endif`` conditionals, ``;`` comments and ``\\`` continuations
    stripped."""

    import os
    import warnings

    if _depth > 16:
        raise ValueError(
            f"'{filename}': #include nesting deeper than 16 "
            "(circular include?)."
        )
    base = os.path.dirname(os.path.abspath(filename))
    with open(filename) as fh:
        raw = fh.read().splitlines()

    # Conditional-inclusion stack: (outer_ok, taking, seen_else) per
    # open #ifdef — `taking` already folds in `outer_ok`, and GROMACS
    # has no #elif, so #else takes iff the branch didn't and the
    # enclosing branches do.
    stack = []
    pending = ""
    for line in raw:
        line = line.split(";", 1)[0]
        if line.rstrip().endswith("\\"):
            pending += line.rstrip()[:-1] + " "
            continue
        line = (pending + line).strip()
        pending = ""
        if not line:
            continue
        if line.startswith("#"):
            fields = line.split()
            directive = fields[0]
            if directive == "#endif":
                if not stack:
                    raise ValueError(
                        f"'{filename}': #endif without #ifdef."
                    )
                stack.pop()
            elif directive == "#else":
                if not stack:
                    raise ValueError(
                        f"'{filename}': #else without #ifdef."
                    )
                outer_ok, taking, seen_else = stack[-1]
                if seen_else:
                    raise ValueError(
                        f"'{filename}': duplicate #else."
                    )
                stack[-1] = (outer_ok, outer_ok and not taking, True)
            elif directive in ("#ifdef", "#ifndef"):
                if len(fields) < 2:
                    raise ValueError(
                        f"'{filename}': {directive} needs a symbol."
                    )
                want = fields[1] in defines
                if directive == "#ifndef":
                    want = not want
                # A false outer branch suppresses the whole block.
                outer_ok = all(t for _, t, _ in stack)
                stack.append((outer_ok, want and outer_ok, False))
            elif not all(t for _, t, _ in stack):
                continue
            elif directive == "#define":
                defines[fields[1]] = (
                    " ".join(fields[2:]) if len(fields) > 2 else ""
                )
            elif directive == "#undef":
                defines.pop(fields[1], None)
            elif directive == "#include":
                target = fields[1].strip('"<>')
                path = (
                    target
                    if os.path.isabs(target)
                    else os.path.join(base, target)
                )
                if os.path.exists(path):
                    yield from _gmx_preprocess(
                        path, defines, _depth + 1
                    )
                else:
                    # Force-field includes ([defaults]/[atomtypes]/
                    # pair parameters) are not needed for the atom
                    # table; a missing *moleculetype* include will
                    # surface as an undefined molecule later.
                    warnings.warn(
                        f"Skipping missing include '{target}' "
                        f"(referenced from '{filename}')."
                    )
            # #error inside a taken branch:
            elif directive == "#error":
                raise ValueError(
                    f"'{filename}': {line}"
                )
            continue
        if stack and not all(t for _, t, _ in stack):
            continue
        yield line


def read_gmx_top(filename: str, *, defines=()) -> dict:
    """Parse a GROMACS ``.top``/``.itp`` topology (the format the
    MDAnalysis reads with its ITP parser).

    Reads ``[ moleculetype ]`` / ``[ atoms ]`` / ``[ bonds ]`` /
    ``[ settles ]`` (settle constraints become the two O-H bonds, as
    in MDAnalysis) across ``#include``\\ d files, collects atom-type
    masses from ``[ atomtypes ]`` as a fallback for omitted per-atom
    masses, and expands the ``[ molecules ]`` composition.  A bare
    ``.itp`` with no ``[ molecules ]`` section instantiates each
    parsed moleculetype once.

    Parameters
    ----------
    filename : `str`
        Path to the ``.top`` or ``.itp`` file.
    defines : iterable of `str` or `dict`, keyword-only, optional
        Preprocessor symbols assumed defined (e.g. ``("FLEXIBLE",)``),
        as with ``grompp -D``.
    """

    defines = (
        dict(defines)
        if isinstance(defines, dict)
        else {name: "" for name in defines}
    )
    moltypes = {}  # name -> {"atoms": [...], "bonds": [...]}
    order = []  # moleculetype definition order
    atomtype_masses = {}
    composition = None  # [(name, count), ...] from [ molecules ]
    section = None
    current = None

    for line in _gmx_preprocess(filename, defines):
        if line.startswith("["):
            section = line.strip("[] \t").lower()
            continue
        fields = line.split()
        if section == "atomtypes":
            # name [btype] [atnum] mass charge ptype V W — locate the
            # single-letter particle-type field; mass sits two left.
            for i, f in enumerate(fields):
                if f.upper() in ("A", "S", "D", "V") and i >= 2:
                    try:
                        atomtype_masses[fields[0]] = float(
                            fields[i - 2]
                        )
                    except ValueError:
                        pass
                    break
        elif section == "moleculetype":
            current = {"atoms": [], "bonds": []}
            moltypes[fields[0]] = current
            order.append(fields[0])
        elif section == "atoms" and current is not None:
            # nr type resnr resname atom cgnr [charge [mass]]
            current["atoms"].append(
                (
                    fields[1],  # type
                    int(fields[2]),  # resnr
                    fields[3],  # resname
                    fields[4],  # atom name
                    float(fields[6]) if len(fields) > 6 else None,
                    float(fields[7]) if len(fields) > 7 else None,
                )
            )
        elif section == "bonds" and current is not None:
            current["bonds"].append(
                (int(fields[0]) - 1, int(fields[1]) - 1)
            )
        elif section == "settles" and current is not None:
            # ai funct doh dhh: rigid water — O bonds to the two
            # following hydrogens.
            ai = int(fields[0]) - 1
            current["bonds"] += [(ai, ai + 1), (ai, ai + 2)]
        elif section == "molecules":
            if composition is None:
                composition = []
            composition.append((fields[0], int(fields[1])))

    if composition is None:
        composition = [(name, 1) for name in order]
    if not composition:
        raise ValueError(
            f"'{filename}' defines no molecules."
        )

    names, types, resnames, resids = [], [], [], []
    charges, masses, segids = [], [], []
    bonds = []
    res_keys, seg_keys = [], []
    offset = 0
    for instance, (molname, count) in enumerate(composition):
        try:
            mol = moltypes[molname]
        except KeyError:
            raise ValueError(
                f"'{filename}': molecule '{molname}' in "
                "[ molecules ] has no [ moleculetype ] definition "
                "(missing #include?)."
            ) from None
        for copy in range(count):
            for (atype, resnr, resname, name, charge,
                 mass) in mol["atoms"]:
                types.append(atype)
                resids.append(resnr)
                resnames.append(resname)
                names.append(name)
                charges.append(0.0 if charge is None else charge)
                if mass is None:
                    mass = atomtype_masses.get(atype)
                if mass is None:
                    mass = _guess_masses([name], from_names=True)[0]
                masses.append(mass)
                res_keys.append(f"{instance}|{copy}|{resnr}")
                seg_keys.append(f"{instance}|{copy}")
                segids.append(molname)
            for ai, aj in mol["bonds"]:
                bonds.append((offset + ai, offset + aj))
            offset += len(mol["atoms"])

    return {
        "n_atoms": offset,
        "names": _object_array(names),
        "types": _object_array(types),
        "charges": np.asarray(charges),
        "masses": np.asarray(masses),
        "resids": np.asarray(resids, dtype=np.int64),
        "resnames": _object_array(resnames),
        "resindices": _factorize(res_keys),
        "segindices": _factorize(seg_keys),
        "segids": _object_array(segids),
        "bonds": np.asarray(bonds, dtype=np.int64).reshape(-1, 2),
    }


def read_prmtop(filename: str) -> dict:
    """Parse an AMBER topology (``.prmtop``/``.parm7``) — the
    ``%FLAG``/``%FORMAT`` fixed-width section format.  Completes the
    AMBER stack with the existing AMBER NetCDF trajectory reader
    (``Universe.from_files("system.prmtop", "traj.nc")``).

    Charges convert from AMBER internal units to elementary charges
    (the 18.2223 convention); bond triples (``BONDS_INC_HYDROGEN`` +
    ``BONDS_WITHOUT_HYDROGEN``) decode via the index*3 convention.
    """

    import re

    with open(filename) as fh:
        text = fh.read()
    if "%FLAG" not in text:
        raise ValueError(f"'{filename}' is not an AMBER prmtop file.")

    sections = {}
    current = None
    fmt = None
    for line in text.splitlines():
        if line.startswith("%FLAG"):
            current = line.split()[1]
            fmt = None
            sections[current] = (None, [])
        elif line.startswith("%FORMAT"):
            fmt = line[line.index("(") + 1:line.rindex(")")]
            sections[current] = (fmt, sections[current][1])
        elif line.startswith("%"):
            continue  # %VERSION / %COMMENT
        elif current is not None:
            sections[current][1].append(line)

    def strings(name):
        fmt, lines = sections[name]
        m = re.match(r"(\d+)[aA](\d+)", fmt)
        width = int(m.group(2))
        out = []
        for line in lines:
            out.extend(
                line[i:i + width].strip()
                for i in range(0, len(line.rstrip("\n")), width)
            )
        return [s for s in out if s]

    def numbers(name, kind=float):
        if name not in sections:
            return []
        _, lines = sections[name]
        out = []
        for line in lines:
            out.extend(kind(x) for x in line.split())
        return out

    pointers = numbers("POINTERS", int)
    if len(pointers) < 12:
        raise ValueError(
            f"'{filename}' has a truncated POINTERS section."
        )
    n_atoms = pointers[0]
    n_res = pointers[11]

    names = strings("ATOM_NAME")[:n_atoms]
    types = (
        strings("AMBER_ATOM_TYPE")[:n_atoms]
        if "AMBER_ATOM_TYPE" in sections
        else list(names)
    )
    charges = (
        np.asarray(numbers("CHARGE")[:n_atoms]) / 18.2223
        if "CHARGE" in sections
        else np.zeros(n_atoms)
    )
    masses = (
        np.asarray(numbers("MASS")[:n_atoms])
        if "MASS" in sections
        else _guess_masses(names, from_names=True)
    )

    res_labels = strings("RESIDUE_LABEL")[:n_res]
    res_ptr = np.asarray(
        numbers("RESIDUE_POINTER", int)[:n_res], dtype=np.int64
    )
    # atom i (0-based) belongs to the residue whose 1-based first
    # atom pointer is the last one <= i + 1
    resindices = (
        np.searchsorted(res_ptr, np.arange(1, n_atoms + 1), "right")
        - 1
    ).astype(np.int64)

    bond_idx = numbers("BONDS_INC_HYDROGEN", int) + numbers(
        "BONDS_WITHOUT_HYDROGEN", int
    )
    bonds = []
    for k in range(0, len(bond_idx), 3):
        bonds.append(
            (bond_idx[k] // 3, bond_idx[k + 1] // 3)
        )
    bonds = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)

    return {
        "n_atoms": n_atoms,
        "names": _object_array(names),
        "types": _object_array(types),
        "charges": charges,
        "masses": masses,
        "resids": resindices + 1,
        "resnames": _object_array(
            [res_labels[r] for r in resindices]
        ),
        "resindices": resindices,
        "segindices": np.zeros(n_atoms, dtype=np.int64),
        "segids": _object_array(["SYSTEM"] * n_atoms),
        "bonds": bonds,
    }


def _read_tpr(filename: str) -> dict:
    from .tpr import read_tpr

    return read_tpr(filename)


_PARSERS = {
    ".prmtop": read_prmtop,
    ".parm7": read_prmtop,
    ".psf": read_psf,
    ".pdb": read_pdb,
    ".gro": read_gro,
    ".data": read_lammps_data,
    ".top": read_gmx_top,
    ".itp": read_gmx_top,
    ".tpr": _read_tpr,
}


def read_topology_file(filename: str) -> dict:
    """Parse a topology file by extension (``.psf``, ``.pdb``,
    ``.gro``, ``.data``, ``.top``/``.itp``,
    ``.prmtop``/``.parm7``, ``.tpr``)."""

    import os

    ext = os.path.splitext(filename)[1].lower()
    try:
        parser = _PARSERS[ext]
    except KeyError:
        raise ValueError(
            f"Unsupported topology extension '{ext}'. Supported: "
            + ", ".join(sorted(_PARSERS))
        ) from None
    return parser(filename)
