"""The port's velocity payloads on the streaming base, and run_together's
one-payload rule, against the JAX package's.

``_payload`` is "positions" (the default), "velocities" (read through
``read_velocity_frames`` and ``read_dimension_frames``, never decoding
positions) or "positions+velocities" (one ``read_frames_with_velocities``
call a chunk, concatenated to ``(B, N, 6)``: columns 0-2 positions, 3-5
velocities).  ``_coord_axes`` slices the payload's columns on the host,
and chunks are sized by the columns streamed.  The same seeded float32
arrays are read through the JAX package's ``_read_payload`` and the
port's, in an ArrayReader and from a TRR file; the port's chunks equal
the float32 cast of the JAX package's payload, column for column.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.analysis import base as jax_base  # noqa: E402
from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.analysis import base, dynamics, flow  # noqa: E402
from mdhelper_tpu_torch.analysis.multi import run_together  # noqa: E402
from mdhelper_tpu_torch.analysis.structure import (  # noqa: E402
    RadialDistributionFunction,
)
from mdhelper_tpu_torch.core.universe import Universe  # noqa: E402

N, T, BOX = 50, 9, 8.0
PAYLOADS = ("positions", "velocities", "positions+velocities")


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(5)
    pos = (rng.random((T, N, 3)) * BOX).astype(np.float32)
    vel = rng.standard_normal((T, N, 3)).astype(np.float32)
    return pos, vel, np.array([BOX] * 3 + [90.0] * 3)


@pytest.fixture(scope="module")
def universes(arrays):
    pos, vel, dims = arrays
    masses = np.linspace(1.0, 3.0, N)
    return (JaxUniverse.from_arrays(pos.astype(np.float64), dims,
                                    velocities=vel.astype(np.float64),
                                    masses=masses),
            Universe.from_arrays(pos, dims, velocities=vel, masses=masses))


def _streamed(u, payload, atoms=None, axes=None, chunk_frames=2,
              prefetch=True):
    a = base.SerialAnalysisBase(u.trajectory, device="cpu")
    a._payload = payload
    a._atom_indices = atoms
    a._coord_axes = axes
    width = len(axes) if axes is not None else a._payload_width()
    n = N if atoms is None else len(atoms)
    a._chunk_bytes = chunk_frames * n * width * 4
    a._prefetch_batches = prefetch
    a._setup_frames()
    batches = list(a._stream_batches())
    return batches, a


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("payload", PAYLOADS)
def test_payload_equals_jax_read(universes, payload, prefetch):
    ju, tu = universes
    jax_side = jax_base.SerialAnalysisBase(ju.trajectory)
    jax_side._payload = payload
    want, want_dims = jax_side._read_payload(np.arange(T))
    batches, a = _streamed(tu, payload, prefetch=prefetch)
    got = torch.cat([b.positions for b in batches]).numpy()
    dims = torch.cat([b.dimensions for b in batches]).numpy()
    assert a._payload_width() == (6 if "+" in payload else 3)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(dims, want_dims)
    assert [len(b.indices) for b in batches] == [2, 2, 2, 2, 1]


# (atoms, axes) of the positions+velocities payload
SLICES = {
    "all": (None, None),
    "velocity_columns": (None, [3, 4, 5]),
    "flow_columns": (np.arange(3, 40, 3), [2, 3, 4, 5]),
    "one_column": (np.arange(N)[::-1], [4]),
}


@pytest.mark.parametrize("case", list(SLICES))
def test_coord_axes_over_six_columns(universes, arrays, case):
    _, tu = universes
    pos, vel, _ = arrays
    atoms, axes = SLICES[case]
    batches, _ = _streamed(tu, "positions+velocities", atoms, axes,
                           chunk_frames=3)
    got = torch.cat([b.positions for b in batches]).numpy()
    full = np.concatenate([pos, vel], axis=-1)
    if atoms is not None:
        full = full[:, atoms]
    if axes is not None:
        full = full[..., axes]
    np.testing.assert_array_equal(got, full)
    # chunks sized by the streamed columns: 3 frames each
    assert [len(b.indices) for b in batches] == [3, 3, 3]


def test_velocity_reads_decode_no_positions(universes, monkeypatch):
    """The velocity payload never reads positions; the combined payload
    reads each chunk with one read_frames_with_velocities call."""

    _, tu = universes
    reader = tu.trajectory
    calls = []

    def forbidden(*args, **kwargs):
        raise AssertionError("positions decoded")

    def counted(name):
        original = getattr(type(reader), name)

        def call(self, *args, **kwargs):
            calls.append(name)
            return original(self, *args, **kwargs)
        return call

    monkeypatch.setattr(type(reader), "read_frames", forbidden)
    monkeypatch.setattr(type(reader), "_read_positions", forbidden,
                        raising=False)
    batches, _ = _streamed(tu, "velocities")
    assert len(batches) == 5
    monkeypatch.undo()
    monkeypatch.setattr(type(reader), "read_frames_with_velocities",
                        counted("read_frames_with_velocities"))
    batches, _ = _streamed(tu, "positions+velocities")
    assert calls == ["read_frames_with_velocities"] * len(batches)


def test_trr_payloads_equal_array_payloads(tmp_path, arrays):
    """From a TRR, both velocity payloads equal the ArrayReader's over the
    arrays that the TRR reader returns (Angstrom and Angstrom/ps)."""

    from mdhelper_tpu_torch.core.trajectory import TRRReader
    from mdhelper_tpu_torch.core.universe import Topology
    from mdhelper_tpu_torch.io.trr import write_trr

    pos, vel, _ = arrays
    path = str(tmp_path / "v.trr")
    write_trr(path, pos / 10.0, np.diag([BOX / 10.0] * 3),
              velocities=vel / 10.0)
    reader = TRRReader(path)
    assert reader.has_velocities
    p, v, d = reader.read_frames_with_velocities(np.arange(T))
    np.testing.assert_allclose(v, vel, rtol=1e-6, atol=1e-6)
    trr_u = Universe(Topology(N), reader)
    arr_u = Universe.from_arrays(p, d, velocities=v)
    for payload in ("velocities", "positions+velocities"):
        a = torch.cat([b.positions for b in _streamed(trr_u, payload)[0]])
        b = torch.cat([b.positions for b in _streamed(arr_u, payload)[0]])
        assert torch.equal(a, b)


def test_run_together_fuses_one_payload_and_raises_on_mixed(universes):
    _, tu = universes

    def flows():
        return [flow.FlowProfile(tu.atoms, n_bins=8, verbose=False,
                                 device="cpu"),
                flow.FlowProfile(tu.atoms[5:30], axis="x", n_bins=5,
                                 remove_drift=False, verbose=False,
                                 device="cpu")]

    fused = run_together(flows())
    for a, b in zip(fused, flows()):
        b.run()
        for key in ("counts", "velocity", "temperature"):
            np.testing.assert_array_equal(a.results[key], b.results[key])

    rdf = RadialDistributionFunction(tu.atoms, n_bins=8, range=(0.0, 3.0),
                                     verbose=False, device="cpu")
    vacf = dynamics.VelocityAutocorrelation(tu.atoms, verbose=False,
                                            device="cpu")
    for mixed in ([rdf, vacf], [vacf, flows()[0]], [flows()[0], rdf]):
        with pytest.raises(ValueError, match="same coordinate payload"):
            run_together(mixed)


def test_jax_run_together_raises_on_mixed_payloads(universes):
    """The JAX package raises the same error the port raises."""

    from mdhelper_tpu.analysis.dynamics import VelocityAutocorrelation
    from mdhelper_tpu.analysis.multi import run_together as jax_together
    from mdhelper_tpu.analysis.structure import (
        RadialDistributionFunction as JaxRDF,
    )

    ju, _ = universes
    with pytest.raises(ValueError, match="same coordinate payload"):
        jax_together([JaxRDF(ju.atoms, n_bins=8, range=(0.0, 3.0),
                             verbose=False),
                      VelocityAutocorrelation(ju.atoms, verbose=False)])
