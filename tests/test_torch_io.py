"""The port's file layer against the JAX package's, on fixtures written to
``tmp_path`` by the JAX writers (and by the TPR encoder of
``tests/test_io_tpr.py``):

* every trajectory reader gives the JAX reader's positions, dimensions,
  times, velocities and forces bit for bit, in every format;
* every writer writes the JAX writer's bytes for the same input;
* every topology parser returns the JAX parser's arrays;
* the native and the Python XTC codecs agree bit for bit, with each
  other and with the JAX package's (the codec is picked by the
  ``use_native=`` argument or ``io._xtc_native.ENABLED``);
* a 100,000-atom GRO and PDB, whose atom and residue numbers wrap,
  round-trip;
* ``Universe.from_files`` builds the JAX universe's atoms and frames,
  and ``guess_bonds`` its bonds.
"""

import gzip
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu import io as jax_io  # noqa: E402
from mdhelper_tpu.algorithm import topology as jax_topology  # noqa: E402
from mdhelper_tpu.core import trajectory as jax_trajectory  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402
from mdhelper_tpu.io import dcd as jax_dcd  # noqa: E402
from mdhelper_tpu.io import lammps_dump as jax_dump  # noqa: E402
from mdhelper_tpu.io import netcdf3 as jax_netcdf3  # noqa: E402
from mdhelper_tpu.io import structure_writers as jax_sw  # noqa: E402
from mdhelper_tpu.io import topology_files as jax_top  # noqa: E402
from mdhelper_tpu.io import trr as jax_trr  # noqa: E402
from mdhelper_tpu.io import xtc as jax_xtc  # noqa: E402
from test_io_topology import (  # noqa: E402
    GMX_IONS_ITP,
    GMX_SOL_ITP,
    GMX_TOP,
    GRO_TEXT,
    PDB_TEXT,
    PRMTOP_TWO_WATERS,
    PSF_TEXT,
)
from test_io_tpr import _encode  # noqa: E402

from mdhelper_tpu_torch import io as port_io  # noqa: E402
from mdhelper_tpu_torch.algorithm import topology as port_topology  # noqa: E402
from mdhelper_tpu_torch.core import trajectory as port_trajectory  # noqa: E402
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402
from mdhelper_tpu_torch.io import _xtc_native  # noqa: E402
from mdhelper_tpu_torch.io import dcd as port_dcd  # noqa: E402
from mdhelper_tpu_torch.io import lammps_dump as port_dump  # noqa: E402
from mdhelper_tpu_torch.io import netcdf3 as port_netcdf3  # noqa: E402
from mdhelper_tpu_torch.io import structure_writers as port_sw  # noqa: E402
from mdhelper_tpu_torch.io import topology_files as port_top  # noqa: E402
from mdhelper_tpu_torch.io import trr as port_trr  # noqa: E402
from mdhelper_tpu_torch.io import xtc as port_xtc  # noqa: E402

N_ATOMS, N_FRAMES, BOX = 37, 5, 20.0
ORTHO = np.array([BOX, BOX + 1.0, BOX + 2.0, 90.0, 90.0, 90.0])
TRICLINIC = np.array([BOX, BOX + 1.0, BOX + 2.0, 70.0, 80.0, 85.0])


def _same_bits(got, ref, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    if ref.dtype == object:
        assert [str(v) for v in got.ravel()] == [str(v) for v in ref.ravel()]
    else:
        assert got.tobytes() == ref.tobytes(), what


def _data(seed=0, n_frames=N_FRAMES, n_atoms=N_ATOMS):
    """(positions, velocities, forces) float64, positions in the box (A)."""

    rng = np.random.default_rng(seed)
    pos = rng.random((n_frames, n_atoms, 3)) * BOX
    vel = rng.normal(0.0, 0.3, pos.shape)
    frc = rng.normal(0.0, 5.0, pos.shape)
    return pos, vel, frc


def _box_matrices(dims6, n_frames=N_FRAMES):
    """(n_frames, 3, 3) GROMACS box matrices in nm."""

    h = np.asarray(jax_topology.triclinic_vectors(dims6), np.float64) / 10
    return np.tile(h, (n_frames, 1, 1))


def _dump_text(pos, dims, layout):
    """A hand-written LAMMPS dump: scaled columns in a triclinic box, or
    unwrapped columns with image flags, ids shuffled."""

    lines = []
    rng = np.random.default_rng(5)
    n = pos.shape[1]
    for f, frame in enumerate(pos):
        lx, ly, lz = dims
        xy, xz, yz = (1.5, -0.5, 0.75) if layout == "scaled" else (0, 0, 0)
        lines += ["ITEM: TIMESTEP", str(100 * f), "ITEM: NUMBER OF ATOMS",
                  str(n)]
        if layout == "scaled":
            lines += ["ITEM: BOX BOUNDS xy xz yz pp pp pp",
                      f"{min(0.0, xy, xz, xy + xz)} "
                      f"{lx + max(0.0, xy, xz, xy + xz)} {xy}",
                      f"{min(0.0, yz)} {ly + max(0.0, yz)} {xz}",
                      f"0.0 {lz} {yz}",
                      "ITEM: ATOMS id type xs ys zs"]
            frac = frame / np.array([lx, ly, lz])
            rows = [f"{i + 1} 1 {a:.9f} {b:.9f} {c:.9f}"
                    for i, (a, b, c) in enumerate(frac)]
        else:
            lines += ["ITEM: BOX BOUNDS pp pp pp", f"0.0 {lx}", f"0.0 {ly}",
                      f"0.0 {lz}", "ITEM: ATOMS id type x y z ix iy iz"]
            img = rng.integers(-2, 3, (n, 3))
            rows = [f"{i + 1} 2 {float(a)!r} {float(b)!r} {float(c)!r} {p} {q} {r}"
                    for i, ((a, b, c), (p, q, r)) in enumerate(zip(frame, img))]
        order = rng.permutation(n)
        lines += [rows[k] for k in order]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Trajectory files of every format, written by the JAX package."""

    from mdhelper_tpu.openmm.file import NetCDFFile

    root = tmp_path_factory.mktemp("trajectories")
    pos, vel, frc = _data()
    out = {}

    def path(name):
        out[name] = str(root / name)
        return out[name]

    np.savez(path("traj.npz"), positions=pos, dimensions=ORTHO,
             times=np.arange(N_FRAMES) * 0.25)
    np.savez(path("traj32.npz"), positions=pos.astype(np.float32))
    jax_dcd.write_dcd(path("ortho.dcd"), pos, np.tile(ORTHO, (N_FRAMES, 1)),
                      delta=0.5, nsavc=10)
    jax_dcd.write_dcd(path("triclinic.dcd"), pos,
                      np.tile(TRICLINIC, (N_FRAMES, 1)))
    jax_dcd.write_dcd(path("nocell.dcd"), pos)
    jax_xtc.write_xtc(path("ortho.xtc"), pos / 10, _box_matrices(ORTHO),
                      dt=2.0)
    jax_xtc.write_xtc(path("triclinic.xtc"), pos / 10,
                      _box_matrices(TRICLINIC), precision=100.0)
    jax_trr.write_trr(path("single.trr"), pos / 10, _box_matrices(ORTHO),
                      velocities=vel / 10, forces=frc * 10)
    jax_trr.write_trr(path("double.trr"), pos / 10,
                      _box_matrices(TRICLINIC), velocities=vel / 10,
                      double=True)
    jax_dump.write_lammps_dump(path("traj.lammpstrj"), pos, ORTHO[:3],
                               steps=np.arange(N_FRAMES) * 50)
    with open(path("scaled.dump"), "w") as fh:
        fh.write(_dump_text(pos, ORTHO[:3], "scaled"))
    with gzip.open(path("images.dump.gz"), "wt") as fh:
        fh.write(_dump_text(pos, ORTHO[:3], "images"))
    jax_sw.write_pdb(path("models.pdb"), pos, dimensions=ORTHO)
    jax_sw.write_gro(path("frames.gro"), pos, dimensions=TRICLINIC)
    jax_sw.write_xyz(path("traj.xyz"), pos,
                     symbols=["C", "O", "H"] * 12 + ["N"])
    nc = NetCDFFile(path("traj.nc")[:-3], "w")
    nc.write_header(N=N_ATOMS, cell=True, velocities=False, forces=False)
    for f in range(N_FRAMES):
        nc.write_model(0.5 * f, pos[f], cell_lengths=ORTHO[:3],
                       cell_angles=ORTHO[3:])
    nc._nc.close()
    return out


READERS = ["traj.npz", "traj32.npz", "ortho.dcd", "triclinic.dcd",
           "nocell.dcd", "ortho.xtc", "triclinic.xtc", "single.trr",
           "double.trr", "traj.lammpstrj", "scaled.dump", "images.dump.gz",
           "models.pdb", "frames.gro", "traj.xyz", "traj.nc"]


@pytest.mark.parametrize("name", READERS)
def test_reader_equals_jax_bit_for_bit(files, name):
    ref = jax_trajectory.open_trajectory(files[name])
    got = port_trajectory.open_trajectory(files[name])
    assert type(got).__name__ == type(ref).__name__
    assert (got.n_frames, got.n_atoms, got.dt) == (ref.n_frames,
                                                   ref.n_atoms, ref.dt)
    _same_bits(got.times, ref.times, "times")
    frames = np.arange(ref.n_frames)
    (pos, dims), (ref_pos, ref_dims) = (got.read_frames(frames),
                                        ref.read_frames(frames))
    if name == "traj32.npz":
        # float32 stays float32 in the port's ArrayReader (the stream
        # dtype); the JAX reader widens it exactly to float64.
        assert pos.dtype == np.float32
        pos = pos.astype(np.float64)
    _same_bits(pos, ref_pos, "positions")
    _same_bits(dims, ref_dims, "dimensions")
    _same_bits(got.read_dimension_frames(frames[::-1]),
               ref.read_dimension_frames(frames[::-1]), "box reads")
    for index in (0, -1):
        a, b = got[index], ref[index]
        _same_bits(np.asarray(a.positions, b.positions.dtype), b.positions)
        _same_bits(a.dimensions, b.dimensions)
        assert (a.time, a.frame) == (b.time, b.frame)
    window = [f.frame for f in got[1:4]]
    assert window == [f.frame for f in ref[1:4]]
    assert [f.frame for f in got] == list(range(ref.n_frames))
    assert got.has_velocities == ref.has_velocities
    assert got.has_forces == ref.has_forces
    if ref.has_velocities:
        _same_bits(got.read_velocity_frames(frames),
                   ref.read_velocity_frames(frames), "velocities")
        for a, b in zip(got.read_frames_with_velocities(frames[1:]),
                        ref.read_frames_with_velocities(frames[1:])):
            _same_bits(a, b, "positions + velocities")
    else:
        with pytest.raises(ValueError):
            got.read_velocity_frames(frames)
    if ref.has_forces:
        _same_bits(got.read_force_frames(frames),
                   ref.read_force_frames(frames), "forces")


def test_array_reader_times_velocities_forces():
    pos, vel, frc = _data(seed=3)
    times = np.array([0.0, 0.5, 2.0, 3.0, 7.5])
    kwargs = dict(dt=0.5, times=times, velocities=vel, forces=frc)
    got = port_trajectory.ArrayReader(pos, ORTHO, **kwargs)
    ref = jax_trajectory.ArrayReader(pos, ORTHO, **kwargs)
    frames = [4, 0, 2]
    _same_bits(got.times, ref.times)
    for a, b in zip(got.read_frames_with_velocities(frames),
                    ref.read_frames_with_velocities(frames)):
        _same_bits(a, b)
    _same_bits(got.read_force_frames(frames), ref.read_force_frames(frames))
    u = Universe.from_arrays(pos, ORTHO, **kwargs)
    ju = JaxUniverse.from_arrays(pos, ORTHO, **kwargs)
    _same_bits(u.trajectory.times, ju.trajectory.times)
    _same_bits(u.trajectory.read_velocity_frames(frames),
               ju.trajectory.read_velocity_frames(frames))
    plain = port_trajectory.ArrayReader(pos)
    assert not plain.has_velocities and not plain.has_forces
    with pytest.raises(ValueError, match="no forces"):
        plain.read_force_frames([0])


def test_open_trajectory_rejects_unknown_extension(tmp_path):
    with pytest.raises(ValueError, match="Unsupported trajectory"):
        port_trajectory.open_trajectory(str(tmp_path / "traj.abc"))


# -- writers -------------------------------------------------------------------

def _write_both(tmp_path, name, write):
    """Bytes that `write(module, path)` leaves, for the JAX and the
    port's modules."""

    out = []
    for side in ("jax", "port"):
        path = tmp_path / f"{side}-{name}"
        write(side, str(path))
        out.append(path.read_bytes())
    return out


def _writer_cases():
    pos, vel, frc = _data(seed=7)
    dims = np.tile(TRICLINIC, (N_FRAMES, 1))
    names = [f"A{i % 3}" for i in range(N_ATOMS)]
    mods = {
        "jax": dict(dcd=jax_dcd, xtc=jax_xtc, trr=jax_trr, dump=jax_dump,
                    sw=jax_sw, io=jax_io, nc=jax_netcdf3),
        "port": dict(dcd=port_dcd, xtc=port_xtc, trr=port_trr,
                     dump=port_dump, sw=port_sw, io=port_io,
                     nc=port_netcdf3),
    }

    def streamed(ext, **kwargs):
        def write(side, path):
            with mods[side]["io"].open_trajectory_writer(
                    path + ext, **kwargs) as w:
                for f in range(N_FRAMES):
                    if ext == ".dump":
                        w.write(pos[f], ORTHO)
                    elif ext == ".dcd":
                        w.write(pos[f], TRICLINIC)
                    else:
                        w.write(pos[f] / 10, _box_matrices(ORTHO)[f])
            os.replace(path + ext, path)
        return write

    def netcdf(side, path):
        ds = mods[side]["nc"].Dataset(path, "w")
        ds.createDimension("frame", None)
        ds.createDimension("atom", N_ATOMS)
        ds.createDimension("spatial", 3)
        ds.Conventions = "AMBER"
        coords = ds.createVariable("coordinates", "f",
                                   ("frame", "atom", "spatial"))
        coords.units = "angstrom"
        time = ds.createVariable("time", "d", ("frame",))
        for f in range(N_FRAMES):
            coords[f] = pos[f]
            time[f] = 0.25 * f
        ds.close()

    return {
        "write_dcd": lambda s, p: mods[s]["dcd"].write_dcd(
            p, pos, dims, istart=3, nsavc=2, delta=0.01),
        "write_xtc": lambda s, p: mods[s]["xtc"].write_xtc(
            p, pos / 10, _box_matrices(TRICLINIC), precision=500.0),
        "write_trr": lambda s, p: mods[s]["trr"].write_trr(
            p, pos / 10, _box_matrices(ORTHO), velocities=vel, forces=frc),
        "write_trr_double": lambda s, p: mods[s]["trr"].write_trr(
            p, pos / 10, None, double=True, times=np.arange(5) * 0.1),
        "write_lammps_dump": lambda s, p: mods[s]["dump"].write_lammps_dump(
            p, pos, TRICLINIC, types=np.arange(N_ATOMS) % 2 + 1),
        "write_pdb": lambda s, p: mods[s]["sw"].write_pdb(
            p, pos, names=names, resids=np.arange(N_ATOMS) // 3 + 1,
            segids=["SEG"] * N_ATOMS, dimensions=ORTHO),
        "write_gro": lambda s, p: mods[s]["sw"].write_gro(
            p, pos[:2], names=names, velocities=vel[:2],
            dimensions=TRICLINIC),
        "write_xyz": lambda s, p: mods[s]["sw"].write_xyz(
            p, pos, symbols=names),
        "DCDWriter": streamed(".dcd", n_atoms=N_ATOMS),
        "XTCWriter": streamed(".xtc", precision=100.0),
        "TRRWriter": streamed(".trr", double=True),
        "LAMMPSDumpWriter": streamed(".dump"),
        "netcdf3.Dataset": netcdf,
    }


WRITERS = list(_writer_cases())


@pytest.mark.parametrize("name", WRITERS)
def test_writer_bytes_equal_jax(tmp_path, name):
    ref, got = _write_both(tmp_path, name, _writer_cases()[name])
    assert len(ref) > 0 and got == ref


@pytest.mark.parametrize("ext", ["pdb", "gro", "xyz"])
def test_atomgroup_write_equals_jax(tmp_path, ext):
    pos, _, _ = _data(seed=8, n_frames=2)
    attrs = dict(names=[f"N{i % 4}" for i in range(N_ATOMS)],
                 resids=np.arange(N_ATOMS) // 2 + 7,
                 types=["C"] * N_ATOMS)
    u = Universe.from_arrays(pos, ORTHO, **attrs)
    ju = JaxUniverse.from_arrays(pos, ORTHO, **attrs)
    u.trajectory[1]
    ju.trajectory[1]
    u.atoms[3:30].write(str(tmp_path / f"port.{ext}"))
    ju.atoms[3:30].write(str(tmp_path / f"jax.{ext}"))
    assert ((tmp_path / f"port.{ext}").read_bytes()
            == (tmp_path / f"jax.{ext}").read_bytes())
    with pytest.raises(ValueError, match="Unsupported structure"):
        u.atoms.write(str(tmp_path / "out.mol2"))


# -- the XTC codecs ------------------------------------------------------------

@pytest.mark.parametrize("n_atoms, scale, precision",
                         [(1000, 5.0, 1000.0), (5000, 0.7, 1000.0),
                          (300, 40.0, 100.0), (7, 3.0, 1000.0)])
def test_xtc_codecs_agree_bit_for_bit(n_atoms, scale, precision):
    assert _xtc_native.load() is not None
    rng = np.random.default_rng(n_atoms)
    coords = rng.random((n_atoms, 3)) * scale
    if n_atoms > 9:
        # molecules: runs of small differences
        coords[1::3] = coords[0::3][: len(coords[1::3])] + 0.05
    native = port_xtc.compress_coords(coords, precision)
    python = port_xtc.compress_coords(coords, precision, use_native=False)
    assert native == python == jax_xtc.compress_coords(coords, precision)
    decoded = [port_xtc.decompress_coords(native, n_atoms),
               port_xtc.decompress_coords(native, n_atoms, use_native=False),
               jax_xtc.decompress_coords(native, n_atoms)]
    for out in decoded[1:]:
        _same_bits(out[0], decoded[0][0])
        assert out[1:] == decoded[0][1:]


def test_xtc_reader_with_native_codec_disabled(files, monkeypatch):
    frames = np.arange(N_FRAMES)
    native = port_trajectory.XTCReader(files["ortho.xtc"]).read_frames(frames)
    monkeypatch.setattr(_xtc_native, "ENABLED", False)
    assert _xtc_native.load() is None
    python = port_trajectory.XTCReader(files["ortho.xtc"]).read_frames(frames)
    for a, b in zip(native, python):
        _same_bits(a, b)


def test_native_codec_builds_into_the_port(tmp_path):
    lib = _xtc_native.load()
    assert lib is not None
    assert _xtc_native._BUILD.name == "_build"
    assert _xtc_native._BUILD.parent.name == "mdhelper_tpu_torch"
    assert _xtc_native._SRC.read_bytes().count(b"xtc_decompress") > 0
    built = sorted(_xtc_native._BUILD.glob("_xtc_native-*.so"))
    assert built and lib._name in {str(p) for p in built}


# -- 100k atoms, wrapped serials -------------------------------------------------

def _wide_system(n=100_000):
    rng = np.random.default_rng(11)
    pos = rng.random((n, 3)) * np.array([95.0, 96.0, 97.0])
    names = np.where(np.arange(n) % 2 == 0, "A", "B")
    resids = np.arange(n) + 1
    return pos, names, resids


@pytest.mark.parametrize("ext", ["gro", "pdb"])
def test_100k_atom_structure_round_trip(tmp_path, ext):
    pos, names, resids = _wide_system()
    path = str(tmp_path / f"wide.{ext}")
    dims = np.array([95.0, 96.0, 97.0, 90.0, 90.0, 90.0])
    write = port_sw.write_gro if ext == "gro" else port_sw.write_pdb
    write(path, pos, names=names, resnames=["RES"] * len(pos),
          resids=resids, dimensions=dims)
    # the last atom's serial wraps to 0
    lines = open(path).read().splitlines()
    last = [line for line in lines if line.startswith("ATOM")][-1] if (
        ext == "pdb") else lines[-2]
    assert (last[6:11] if ext == "pdb" else last[15:20]) == "    0"
    got = port_top.read_topology_file(path)
    ref = jax_top.read_topology_file(path)
    assert got["n_atoms"] == len(pos) == ref["n_atoms"]
    assert sorted(got) == sorted(ref)
    for key in ref:
        if key != "n_atoms":
            _same_bits(got[key], ref[key], key)
    np.testing.assert_array_equal(got["names"], names)
    # GRO keeps 3 decimals of nm, PDB 3 of Angstrom
    atol = 5e-3 + 1e-9 if ext == "gro" else 5e-4 + 1e-9
    np.testing.assert_allclose(got["positions"], pos, rtol=0, atol=atol)
    np.testing.assert_allclose(got["dimensions"], dims, atol=1e-3)
    reader = port_trajectory.open_trajectory(path)
    assert reader.n_atoms == len(pos) and reader.n_frames == 1
    u = Universe.from_files(path)
    assert u.select_atoms("name B").n_atoms == len(pos) // 2


# -- topology files ----------------------------------------------------------------

def _topologies(root):
    """Topology files of every format the parsers read."""

    from mdhelper_tpu.lammps.topology import write_data

    out = {}
    for name, text in (("water.psf", PSF_TEXT), ("protein.pdb", PDB_TEXT),
                       ("water.gro", GRO_TEXT), ("sol.itp", GMX_SOL_ITP),
                       ("ions.itp", GMX_IONS_ITP), ("system.top", GMX_TOP),
                       ("wat2.prmtop", PRMTOP_TWO_WATERS)):
        (root / name).write_text(text)
        out[name] = str(root / name)
    (root / "topol.tpr").write_bytes(_encode(127, 28, 4))
    (root / "classic.tpr").write_bytes(_encode(112, 26, 8, tilted=True))
    out["topol.tpr"] = str(root / "topol.tpr")
    out["classic.tpr"] = str(root / "classic.tpr")
    rng = np.random.default_rng(9)
    out["system.data"] = str(root / "system.data")
    write_data(out["system.data"], [rng.random((4, 3)) * 10,
                                    rng.random((6, 3)) * 10],
               dimensions=np.array([10.0, 10.0, 10.0]), masses=[12.0, 1.0],
               charges=[0.5, -1.0 / 3.0],
               bonds=[np.array([[1, 2], [3, 4]]), np.array([[5, 6]])])
    return out


TOPOLOGIES = ["water.psf", "protein.pdb", "water.gro", "sol.itp",
              "system.top", "wat2.prmtop", "topol.tpr", "classic.tpr",
              "system.data"]


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_parser_equals_jax(tmp_path, name):
    path = _topologies(tmp_path)[name]
    got = port_top.read_topology_file(path)
    ref = jax_top.read_topology_file(path)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        if isinstance(value, (int, np.integer)):
            assert got[key] == value
        else:
            _same_bits(got[key], value, key)


def test_guess_masses_equals_jax():
    labels = ["C", "CA", "HE1", "OW", "NA", "CL", "Fe", "Xx", "H2O", "S"]
    for from_names in (False, True):
        _same_bits(port_top._guess_masses(labels, from_names=from_names),
                   jax_top._guess_masses(labels, from_names=from_names))


FROM_FILES = [
    ("water.psf", "ortho.dcd"),
    ("topol.tpr", "ortho.xtc"),
    ("system.top", "triclinic.xtc"),
    ("wat2.prmtop", "single.trr"),
    ("system.data", None),
    ("water.gro", None),
    ("frames.gro", None),
    ("models.pdb", None),
    ("traj.xyz", "traj.lammpstrj"),
]


@pytest.mark.parametrize("topology, trajectory", FROM_FILES)
def test_from_files_equals_jax(tmp_path, files, topology, trajectory):
    tops = _topologies(tmp_path)
    top_path = tops.get(topology, files.get(topology))
    traj_path = None
    if trajectory is not None:
        # the trajectory cut to the topology's atoms, written by the JAX
        # package in the trajectory's format
        n = jax_top.read_topology_file(top_path)["n_atoms"] if (
            not topology.endswith(".xyz")) else N_ATOMS
        pos = jax_trajectory.open_trajectory(files[trajectory]).read_frames(
            np.arange(N_FRAMES))[0][:, :n]
        traj_path = str(tmp_path / f"cut-{trajectory}")
        if trajectory.endswith(".dcd"):
            jax_dcd.write_dcd(traj_path, pos, np.tile(ORTHO, (N_FRAMES, 1)))
        elif trajectory.endswith(".xtc"):
            jax_xtc.write_xtc(traj_path, pos / 10, _box_matrices(TRICLINIC))
        elif trajectory.endswith(".trr"):
            jax_trr.write_trr(traj_path, pos / 10, _box_matrices(ORTHO),
                              velocities=pos / 100)
        else:
            jax_dump.write_lammps_dump(traj_path, pos, ORTHO[:3])
    u = Universe.from_files(top_path, traj_path)
    ju = JaxUniverse.from_files(top_path, traj_path)
    assert type(u.trajectory).__name__ == type(ju.trajectory).__name__
    assert u.trajectory.n_frames == ju.trajectory.n_frames
    for attr in ("masses", "charges", "types", "names", "resindices",
                 "segindices", "resids", "resnames", "segids", "bonds"):
        _same_bits(getattr(u._topology, attr), getattr(ju._topology, attr),
                   attr)
    frames = np.arange(u.trajectory.n_frames)
    for a, b in zip(u.trajectory.read_frames(frames),
                    ju.trajectory.read_frames(frames)):
        _same_bits(np.asarray(a, b.dtype), b)
    _same_bits(u.atoms.positions, ju.atoms.positions)
    _same_bits(u.dimensions, ju.dimensions)


def test_from_files_needs_coordinates(tmp_path):
    tops = _topologies(tmp_path)
    for universe in (Universe, JaxUniverse):
        with pytest.raises(ValueError, match="carries no coordinates"):
            universe.from_files(tops["water.psf"])


@pytest.mark.parametrize("case", ["gro_waters", "periodic", "open"])
def test_guess_bonds_equals_jax(tmp_path, case):
    if case == "gro_waters":
        path = _topologies(tmp_path)["water.gro"]
        u, ju = Universe.from_files(path), JaxUniverse.from_files(path)
        got, ref = u.guess_bonds(), ju.guess_bonds()
        _same_bits(u._topology.bonds, ref)
        _same_bits(got, ref)
        assert len(ref) == 4
        return
    rng = np.random.default_rng(21)
    n = 400
    pos = rng.random((n, 3)) * 12.0
    labels = rng.choice(["C", "H", "O", "N", "CL", "CA"], n)
    dims = np.full(3, 12.0) if case == "periodic" else None
    kwargs = dict(fudge_factor=0.6, vdwradii={"CL": 1.75})
    got = port_topology.guess_bonds(labels, pos, dims, **kwargs)
    ref = jax_topology.guess_bonds(labels, pos, dims, **kwargs)
    assert len(ref) > 0
    _same_bits(got, ref)
    _same_bits(port_topology.resolve_vdw_radii(labels, vdwradii={"CA": 2.0}),
               jax_topology.resolve_vdw_radii(labels, vdwradii={"CA": 2.0}))
