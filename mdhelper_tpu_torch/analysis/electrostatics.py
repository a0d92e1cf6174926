r"""
Electrostatics
==============

Ported from :mod:`mdhelper_tpu.analysis.electrostatics`: instantaneous
dipole moments :math:`\mathbf{M} = \sum_i q_i \mathbf{r}_i` per group
(:class:`DipoleMoment`), the relative permittivity from their
fluctuations (:func:`calculate_relative_permittivity`) and the
frequency-dependent dielectric function (
:func:`calculate_dielectric_spectrum`).

Each chunk's float32 positions (unwrapped frame by frame with image
counts carried across chunks, from molecules made whole at the first
frame, with ``unwrap=True``) are weighted by the float64 charges and
summed in float64 on the device; the JAX package sums float32 products
in float32.  The per-frame dipoles and box volumes reach the host one
chunk late.  The JAX package's two departures from its reference hold
here too: no stray per-frame shift of the first atom, and
``neutralize=True`` subtracts each residue's net charge at its center of
mass, once.
"""

from numbers import Real
from typing import Union

import numpy as np
import torch

from .. import Q_, ureg
from .._device import resolve_device
from ..algorithm.correlation import _host, correlation_fft
from ..algorithm.topology import unwrap_edge
from ..algorithm.unit import strip_unit
from ..ops.pbc import unwrap_scan
from .base import DynamicAnalysisBase, Hash
from .structure import _group_segment_ids

__all__ = [
    "calculate_dielectric_spectrum",
    "calculate_relative_permittivity",
    "DipoleMoment",
]


def _dipole_scale() -> float:
    r""":math:`(e\,\mathrm{\AA})^2 / (\varepsilon_0\,\mathrm{\AA}^3\,
    k_\mathrm{B}\,\mathrm{K})`, dimensionless."""

    return (
        (1 * ureg.elementary_charge * ureg.angstrom) ** 2
        / (
            ureg.vacuum_permittivity
            * ureg.angstrom**3
            * ureg.boltzmann_constant
            * ureg.kelvin
        )
    ).to_reduced_units().magnitude


def calculate_relative_permittivity(
    M: np.ndarray,
    temperature: float,
    volume: float,
    *,
    reduced: bool = False,
) -> float:
    r"""Relative permittivity from dipole-moment fluctuations (Neumann
    1983):

    .. math::

       \varepsilon_\mathrm{r} = 1 + \frac{\overline{\langle M^2\rangle
       - \langle M\rangle^2}}{3\varepsilon_0 V k_\mathrm{B} T}

    (the component mean absorbs the factor of 3).

    Parameters
    ----------
    M : array-like
        Instantaneous dipole moments ``(N_t, 3)`` (e A).
    temperature : `float`
        Temperature (K), or the energy scale when ``reduced=True``.
    volume : `float`
        System volume (A^3; a series is averaged).
    reduced : `bool`, keyword-only
        Reduced (LJ) units.
    """

    M = np.asarray(M, dtype=float)
    fluctuation = (M**2 - M.mean(axis=0) ** 2).mean()
    mean_volume = float(np.asarray(volume).mean())
    if reduced:
        return 1 + 4 * np.pi * fluctuation / (mean_volume * temperature)
    return 1 + _dipole_scale() * fluctuation / (mean_volume * temperature)


class DipoleMoment(DynamicAnalysisBase):
    r"""Instantaneous dipole moment vectors
    :math:`\mathbf{M}(t) = \sum_i q_i \mathbf{r}_i` per group, as the JAX
    package's class.

    Results: ``results.dipoles`` ``(n_frames, G, 3)`` (float64, e A),
    ``results.volumes`` ``(n_frames,)`` (A^3; both averaged over the
    frames with ``average=True``), and ``results.times``.

    Parameters
    ----------
    groups : `AtomGroup` or array-like
        Group(s) of atoms.
    charges : array-like, optional
        Per-group scalar charges or per-atom charge arrays (default: the
        topology's).
    dimensions : array-like, optional
        Box lengths (the unwrap's box); multiplied by `scales`.
    scales : `float` or array-like, default 1
        Box scaling factors.
    average : `bool`, default False
        Time-average the dipoles and volumes.
    reduced : `bool`, default False
        Reduced (LJ) units (the permittivity only).
    neutralize : `bool`, default False
        Subtract each residue's net charge at its center of mass.
    unwrap : `bool`, default False
        Unwrap positions by image counts, from molecules made whole at
        the first frame.
    parallel : `bool`, default False
        Shard the frames over the ranks (``unwrap=True`` is
        order-dependent and runs on one rank only).
    verbose : `bool`, default True
        Log the start and end of :meth:`run`.
    device : `torch.device` or `str`, keyword-only, optional
        Where the chunks are reduced (default: the first CUDA device).
    """

    _checkpointable_stores = True
    _rank_sharded = True

    def __init__(
        self,
        groups,
        charges=None,
        dimensions=None,
        scales: Union[float, tuple] = 1,
        average: bool = False,
        reduced: bool = False,
        neutralize: bool = False,
        unwrap: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        *,
        device=None,
        **kwargs,
    ) -> None:
        self._groups = (
            [groups] if hasattr(groups, "universe") else list(groups)
        )
        self._n_groups = len(self._groups)
        self.universe = self._groups[0].universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)

        if dimensions is not None:
            if len(dimensions) != 3:
                raise ValueError("'dimensions' must have length 3.")
            self._dimensions = np.asarray(
                strip_unit(dimensions, "angstrom")[0]
            )
        elif self.universe.dimensions is not None:
            self._dimensions = self.universe.dimensions[:3].copy()
        else:
            raise ValueError("No system dimensions found or provided.")

        if isinstance(scales, Real) or (
            len(scales) == 3 and isinstance(scales[0], Real)
        ):
            self._dimensions = self._dimensions * scales
        else:
            raise ValueError(
                "The scaling factor(s) must be provided as a "
                "floating-point number or in an array with shape (3,)."
            )

        self._Ns = np.fromiter((g.n_atoms for g in self._groups), dtype=int,
                               count=self._n_groups)
        self._N = int(self._Ns.sum())
        self._slices = []
        index = 0
        for n in self._Ns:
            self._slices.append(slice(index, index + int(n)))
            index += int(n)

        if charges is not None:
            charges = list(charges)
            if len(charges) != self._n_groups:
                raise ValueError(
                    "The number of group charge arrays is not equal to the "
                    "number of groups."
                )
            for i, (g, q) in enumerate(zip(self._groups, charges)):
                q = strip_unit(q, "elementary_charge")[0]
                if isinstance(q, Real):
                    q = q * np.ones(g.n_atoms)
                elif g.n_atoms != len(q):
                    raise ValueError(
                        f"The number of charges in 'charges[{i}]' is not "
                        "equal to the number of atoms in the corresponding "
                        "group."
                    )
                charges[i] = np.asarray(q, dtype=float)
            self._charges = charges
        else:
            self._charges = [g.charges for g in self._groups]

        # The permittivity needs a neutral system, all of it in the groups.
        topology = self.universe._topology
        residue_charges = np.zeros(topology.n_residues)
        _, inverse = np.unique(topology.resindices, return_inverse=True)
        np.add.at(residue_charges, inverse, topology.charges)
        self._all_neutral = np.allclose(residue_charges, 0, atol=1e-6)
        self._all_included = (
            sum(g.n_atoms for g in self._groups)
            == self.universe.atoms.n_atoms
        )

        self._average = average
        self._reduced = reduced
        self._neutralize = neutralize
        self._unwrap = unwrap
        self._sequential = unwrap
        self._atom_indices = np.concatenate([g.ix for g in self._groups])

    def _effective_charges(self) -> list:
        """Per-atom float64 charges, optionally neutralized per residue."""

        if not self._neutralize:
            return [np.asarray(q, dtype=float) for q in self._charges]
        out = []
        for g, q in zip(self._groups, self._charges):
            q = np.asarray(q, dtype=float).copy()
            seg, n = _group_segment_ids(g, "residues")
            net = np.zeros(n)
            np.add.at(net, seg, q)
            total_mass = np.zeros(n)
            np.add.at(total_mass, seg, g.masses)
            q -= net[seg] * g.masses / total_mass[seg]
            out.append(q)
        return out

    def _prepare(self) -> None:
        self.results.dipoles = np.zeros((self.n_frames, self._n_groups, 3))
        self.results.volumes = np.empty(self.n_frames)
        self.results.units = {
            "dipoles": ureg.elementary_charge * ureg.angstrom,
            "volumes": ureg.angstrom**3,
        }
        if not self._average:
            self.results.times = self.frames * self._trajectory.dt
            self.results.units["times"] = ureg.picosecond
        self._store_offset = 0

        device = self._device
        box = torch.as_tensor(np.asarray(self._dimensions, np.float32),
                              device=device)
        charges = [torch.as_tensor(q, dtype=torch.float64, device=device)
                   for q in self._effective_charges()]
        slices = self._slices
        unwrap = self._unwrap

        if unwrap:
            # Molecules made whole at the first analyzed frame.
            self.universe.trajectory[int(self.frames[0])]
            first = np.concatenate([unwrap_edge(group=g)
                                    for g in self._groups])
            self._carry = (
                torch.as_tensor(first.astype(np.float32), device=device),
                torch.zeros((self._N, 3), dtype=torch.int32, device=device),
            )
        else:
            self._carry = (torch.zeros((), device=device),
                           torch.zeros((), device=device))

        def dipoles_of(positions):
            """float32 ``(B, N, 3)`` -> float64 ``(B, G, 3)``."""

            return torch.stack([
                (q[:, None] * positions[:, s].to(torch.float64)).sum(1)
                for s, q in zip(slices, charges)
            ], dim=1)

        def update(carry, positions, dimensions, mask):
            del mask
            if unwrap:
                positions, carry = unwrap_scan(positions, box,
                                               initial=carry[0],
                                               images=carry[1])
            volumes = dimensions[:, :3].prod(dim=1)
            return carry, (dipoles_of(positions), volumes)

        self._update = update

    def _result_stores(self) -> dict:
        return {"dipoles": 0, "volumes": 0}

    def _store_chunk(self, extras, batch) -> None:
        # A rank's padded tail (mask 0) ends the chunk: only the real
        # frames are stored.
        dipoles, volumes = extras
        n_real = batch.n_real
        lo = self._store_offset
        self.results.dipoles[lo:lo + n_real] = dipoles[:n_real]
        self.results.volumes[lo:lo + n_real] = volumes[:n_real]
        self._store_offset += n_real

    def _conclude(self) -> None:
        if self._average:
            self.results.dipoles = self.results.dipoles.mean(axis=0)
            self.results.volumes = self.results.volumes.mean()

    def calculate_relative_permittivity(
        self, temperature: Union[float, Q_]
    ) -> None:
        """Relative permittivity from the dipoles (summed over the groups)
        as ``results.dielectric``.  Refused for averaged dipoles, a system
        with charged residues unless ``neutralize=True``, or groups that
        leave atoms out."""

        if self._average:
            raise RuntimeError(
                "Cannot compute relative permittivity using the averaged "
                "dipole moment."
            )
        if not self._all_neutral and not self._neutralize:
            raise RuntimeError(
                "Cannot compute relative permittivity for a non-neutral "
                "system or a system with ions unless the net charge is "
                "subtracted at the center of mass of each molecule "
                "carrying a net charge."
            )
        if not self._all_included:
            raise RuntimeError(
                "Cannot compute relative permittivity when not all atoms "
                "in the system are accounted for in the groups."
            )
        temperature, unit_ = strip_unit(temperature, "kelvin")
        if self._reduced and not isinstance(unit_, (str, type(None))):
            raise ValueError(
                "'temperature' cannot have units when reduced=True."
            )
        dipoles = self.results.dipoles
        if self._n_groups > 1:
            dipoles = dipoles.sum(axis=1)
        else:
            dipoles = dipoles[:, 0]
        self.results.dielectric = calculate_relative_permittivity(
            dipoles, temperature, self.results.volumes.mean(),
            reduced=self._reduced,
        )


def calculate_dielectric_spectrum(
    M: np.ndarray,
    temperature: float,
    volume: float,
    dt: float,
    *,
    t_max: float = None,
    reduced: bool = False,
    device=None,
) -> Hash:
    r"""Frequency-dependent dielectric function :math:`\varepsilon(\nu)`
    from the total dipole series (linear response):

    .. math::

       \varepsilon(\omega) - 1 = \frac{\langle M^2 \rangle -
       \langle M \rangle^2}{3\varepsilon_0 V k_\mathrm{B} T}
       \left[ 1 - i\omega \int_0^\infty \Phi(t)
       e^{-i\omega t}\,dt \right],

    with :math:`\Phi(t)` the normalized dipole autocorrelation
    (:func:`~mdhelper_tpu_torch.algorithm.correlation.correlation_fft`,
    float64) and the one-sided transform a half-sample-shifted rectangle
    rule on the ``rfftfreq`` grid (one real FFT), as the JAX package.

    Parameters
    ----------
    M : array-like
        Dipole series ``(N_t, 3)`` (e A).
    temperature : `float`
        Temperature (K), or the energy scale when ``reduced=True``.
    volume : `float`
        System volume (A^3).
    dt : `float`
        Series time step (ps).
    t_max : `float`, keyword-only, optional
        Truncate :math:`\Phi(t)` at this lag (ps) before the transform.
    reduced : `bool`, keyword-only
        Reduced (LJ) units.
    device : `torch.device` or `str`, keyword-only, optional
        Where the autocorrelation's FFT runs (default: the first CUDA
        device; raises `RuntimeError` without one).  Pass ``"cpu"`` for
        the CPU.

    Returns
    -------
    results : `Hash`
        ``frequencies`` (1/ps), ``acf`` (normalized :math:`\Phi(t)`),
        ``epsilon`` (complex :math:`\varepsilon(\nu) - 1`),
        ``delta_epsilon`` (the static strength) and ``units`` (omitted
        when reduced).
    """

    M = np.asarray(M, dtype=np.float64)
    if M.ndim != 2 or M.shape[1] != 3:
        raise ValueError("M must have shape (N_t, 3).")
    temperature, _ = strip_unit(temperature, "kelvin")
    volume, _ = strip_unit(volume, "angstrom**3")
    dt, _ = strip_unit(dt, "picosecond")

    fluct = M - M.mean(axis=0)
    acf = _host(correlation_fft(
        torch.as_tensor(fluct, device=resolve_device(device)), axis=0,
        vector=True))
    if not acf[0] > 0:
        raise ValueError(
            "The dipole series has zero variance (rigid/frozen system); "
            "the dielectric spectrum is undefined."
        )
    phi = acf / acf[0]
    if t_max is not None:
        t_max, _ = strip_unit(t_max, "picosecond")
        keep = max(2, min(len(phi), int(round(t_max / dt))))
        phi = phi[:keep]
    n_t = len(phi)
    freqs = np.fft.rfftfreq(n_t, dt)
    omega = 2 * np.pi * freqs
    laplace = dt * np.exp(-1j * omega * dt / 2) * np.fft.rfft(phi)
    if reduced:
        strength = 4 * np.pi * acf[0] / (3 * volume * temperature)
    else:
        strength = _dipole_scale() * acf[0] / (3 * volume * temperature)
    epsilon = strength * (1.0 - 1j * omega * laplace)
    out = Hash(
        frequencies=freqs,
        acf=phi,
        epsilon=epsilon,
        delta_epsilon=float(strength),
    )
    if not reduced:
        out.units = Hash(frequencies=1 / ureg.picosecond)
    return out
