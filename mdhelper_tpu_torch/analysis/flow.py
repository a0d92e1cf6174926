r"""
Flow / temperature profiles
===========================

Axis-resolved hydrodynamic fields for non-equilibrium MD (shear flow,
Poiseuille flow, thermal gradients): number and mass density,
mass-weighted streaming velocity :math:`u_\alpha(z)`, and kinetic
temperature :math:`T(z)`, binned along one box axis, ported from
:mod:`mdhelper_tpu.analysis.flow` (LAMMPS' ``fix ave/chunk vx vy vz
temp`` / ``compute temp/profile`` observables).

The stream carries the ``"positions+velocities"`` payload and
``_coord_axes`` slices it to the four columns read (the profiled
coordinate and the three velocity components).  Each chunk's
coordinates wrap and bin in float32 against the float64
``numpy.linspace`` edges rounded to float32 (the JAX package's
``_bin_indices``), so counts equal the JAX package's; the weighted
per-frame histograms (:math:`\sum m`, :math:`\sum m w_\alpha`,
:math:`\sum m |w|^2`) are ``bincount`` sums of float64 weights formed from
the float32 velocities, where the JAX package sums float32 weights in
float32.

The kinetic temperature removes the per-bin streaming velocity by
default (the NEMD convention; LAMMPS ``compute temp/profile``):

.. math::

   \frac{3 (N_b - 1)}{2} k_\mathrm{B} T_b = \frac{1}{2} \left(
   \sum_{i \in b} m_i |\mathbf{w}_i|^2 - \frac{|\sum_{i \in b} m_i
   \mathbf{w}_i|^2}{\sum_{i \in b} m_i} \right),
   \qquad
   \mathbf{w}_i = \mathbf{v}_i - \mathbf{u}_\mathrm{com}(t_i),

with the per-bin sums over atoms *and* frames and
:math:`\mathbf{u}_\mathrm{com}(t)` the instantaneous mass-weighted mean
velocity of the group.  The sums are kept centered; the reported
streaming velocity and the ``remove_drift=False`` temperature add exact
float64 laboratory-frame terms (``drift``, ``boost``), as in the JAX
package.
"""

import numpy as np
import torch

from .. import ureg
from ..ops.pbc import wrap_positions
from ..ops.profiles import _bin_indices, _frame_valid, bin_counts
from .base import DynamicAnalysisBase

__all__ = ["FlowProfile"]


class FlowProfile(DynamicAnalysisBase):
    r"""Axis-binned hydrodynamic profiles: number/mass density,
    streaming velocity, and kinetic temperature.

    Parameters
    ----------
    group : `AtomGroup`
        Atoms to profile.  Masses come from the topology.
    axis : `str`, default :code:`"z"`
        Profiled box axis (``"x"``, ``"y"`` or ``"z"``).
    n_bins : `int`, default 100
        Bins along the axis.
    remove_drift : `bool`, keyword-only, default True
        Subtract the instantaneous global center-of-mass velocity
        and the per-bin (time-averaged) residual streaming velocity
        from the kinetic temperature, counting three degrees of
        freedom per bin (``dof = 3 (N_b - 1)``); with ``False``, the
        raw laboratory-frame kinetic energy is used
        (``dof = 3 N_b``).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units: :math:`k_\mathrm{B} = 1` and no
        ``results.units``.
    parallel : `bool`, keyword-only, default False
        Shard the frames over the ranks (the histograms drop a rank's
        padded frames by the mask; the float64 sums add up over the
        ranks).
    device : `torch.device` or `str`, keyword-only, optional
        Where the chunks are binned (default: the first CUDA device);
        ``"cpu"`` for the CPU.

    Results
    -------
    ``results.bins``
        Bin centers (Å).
    ``results.counts``
        Per-bin atom counts summed over frames.
    ``results.number_density``, ``results.mass_density``
        Time-averaged densities (Å⁻³ and u·Å⁻³; initialization-box
        bin volume, the profile-class convention).
    ``results.velocity``
        Mass-weighted streaming velocity per bin, shape
        ``(n_bins, 3)`` (Å/ps; NaN in empty bins).
    ``results.temperature``
        Kinetic temperature per bin (K, or
        :math:`k_\mathrm{B} T / \epsilon` when reduced; NaN where the
        degrees of freedom vanish).

    Notes
    -----
    Bond/constraint degrees of freedom are not deducted (atoms are
    treated as free particles); rigid-molecule temperatures need the
    per-bin dof corrected by the caller.  With ``remove_drift=True`` the
    per-frame global-COM centering consumes 3 dof per frame, but only the
    3 per-bin streaming-mean dof are deducted, so T is biased low by
    ~:math:`1/N_\mathrm{atoms}` relative to LAMMPS ``compute temp/com``
    on the whole system (the JAX package's convention).
    """

    _payload = "positions+velocities"
    _rank_sharded = True

    def __init__(
        self,
        group,
        axis: str = "z",
        n_bins: int = 100,
        *,
        remove_drift: bool = True,
        reduced: bool = False,
        parallel: bool = False,
        verbose: bool = True,
        device=None,
        **kwargs,
    ) -> None:
        self.universe = group.universe
        super().__init__(self.universe.trajectory, parallel, verbose,
                         device=device, **kwargs)
        if group.n_atoms == 0:
            raise ValueError("Empty atom group.")
        if not getattr(self._trajectory, "has_velocities", False):
            raise ValueError(
                "FlowProfile needs a trajectory with velocities."
            )
        self._setup_periodic_box()
        if self._triclinic:
            raise ValueError("FlowProfile needs an orthorhombic cell.")
        self._require_box("FlowProfile")
        if axis not in ("x", "y", "z"):
            raise ValueError("axis must be 'x', 'y' or 'z'.")
        self._axis = "xyz".index(axis)
        if int(n_bins) < 1:
            raise ValueError("'n_bins' must be positive.")
        self._n_bins = int(n_bins)
        self._atom_indices = np.asarray(group.ix)
        self._masses = np.asarray(group.masses, dtype=np.float64)
        self._remove_drift = bool(remove_drift)
        self._reduced = reduced
        self._dimensions = np.asarray(
            self.universe.dimensions[:3], dtype=np.float64
        )

    def _prepare(self) -> None:
        # the profiled coordinate and the three velocity components of
        # the (B, N, 6) payload
        self._coord_axes = [self._axis, 3, 4, 5]
        length = self._dimensions[self._axis]
        self._edges = np.linspace(0.0, length, self._n_bins + 1)
        self.results.bins = (self._edges[:-1] + self._edges[1:]) / 2
        if not self._reduced:
            self.results.units = {
                "results.bins": ureg.angstrom,
                "results.number_density": ureg.angstrom**-3,
                "results.mass_density": (
                    ureg.unified_atomic_mass_unit * ureg.angstrom**-3
                ),
                "results.velocity": ureg.angstrom / ureg.picosecond,
                "results.temperature": ureg.kelvin,
            }
        device = self._device
        # centered per-bin moments (mw*, mw2) and the float64
        # laboratory-frame terms (drift*, boost)
        self._carry = {
            k: torch.zeros(self._n_bins, dtype=torch.float64, device=device)
            for k in ("n", "m", "mwx", "mwy", "mwz", "mw2",
                      "driftx", "drifty", "driftz", "boost")
        }
        self._make_update()

    def _make_update(self) -> None:
        device = self._device
        n_bins = self._n_bins
        # float64 linspace edges rounded to the float32 stream
        edges = torch.as_tensor(self._edges.astype(np.float32),
                                device=device)
        masses = torch.as_tensor(self._masses, device=device)
        m_total = float(self._masses.sum())
        ax = self._axis

        def update(carry, positions, dimensions, mask):
            # positions holds the profiled coordinate, then the velocity
            coord = positions[..., 0]
            vel = positions[..., 1:4].to(torch.float64)
            # wrap with each frame's own box length (one rounding, as XLA
            # fuses it); the bin grid stays the initialization-time cell
            length = dimensions[:, ax, None].to(coord.dtype)
            coord = torch.where(
                length > 0,
                wrap_positions(coord, length), coord)
            u_com = (masses[None, :, None] * vel).sum(dim=1) / m_total
            w = vel - u_com[:, None, :]
            mw = masses[None, :, None] * w  # (B, N, 3)
            mw2 = (mw * w).sum(dim=-1)  # (B, N)

            frames = coord.shape[0]
            idx, ok = _bin_indices(coord, edges)
            ok = _frame_valid(ok, mask)
            ids = idx + torch.arange(frames, device=device)[:, None] * n_bins
            size = frames * n_bins

            def hist(weights=None):
                out = bin_counts(ids, ok, size, weights)
                return out.reshape(frames, n_bins).to(torch.float64)

            n_f = hist()
            m_f = hist(masses)
            mw_f = torch.stack([hist(mw[..., a]) for a in range(3)], dim=1)
            mw2_f = hist(mw2)
            # drift_a = sum_f u_com[f, a] m_f(bin) recovers the raw
            # streaming velocity; boost the raw second moment,
            # sum m|v|^2 = mw2 + 2 u.mw + |u|^2 m, frame by frame
            drift = (u_com[:, :, None] * m_f[:, None, :]).sum(dim=0)
            boost = (2.0 * (u_com[:, :, None] * mw_f).sum(dim=1)
                     + (u_com * u_com).sum(dim=1)[:, None] * m_f).sum(dim=0)
            new = {
                "n": n_f.sum(dim=0),
                "m": m_f.sum(dim=0),
                "mwx": mw_f[:, 0].sum(dim=0),
                "mwy": mw_f[:, 1].sum(dim=0),
                "mwz": mw_f[:, 2].sum(dim=0),
                "mw2": mw2_f.sum(dim=0),
                "driftx": drift[0],
                "drifty": drift[1],
                "driftz": drift[2],
                "boost": boost,
            }
            return {k: carry[k] + v for k, v in new.items()}

        self._update = update

    def _conclude(self) -> None:
        carry = {k: v.cpu().numpy() for k, v in self._carry.items()}
        n, m, mw2 = carry["n"], carry["m"], carry["mw2"]
        mw = np.stack([carry["mwx"], carry["mwy"], carry["mwz"]], axis=-1)
        drift = np.stack(
            [carry["driftx"], carry["drifty"], carry["driftz"]], axis=-1
        )
        self.results.counts = n
        volume = np.prod(self._dimensions)
        denom = self._n_bins / (volume * self.n_frames)
        self.results.number_density = n * denom
        self.results.mass_density = m * denom
        with np.errstate(divide="ignore", invalid="ignore"):
            m_safe = np.maximum(m, 1e-300)
            self.results.velocity = np.where(
                m[:, None] > 0, (mw + drift) / m_safe[:, None], np.nan
            )
            if self._remove_drift:
                kinetic = mw2 - (mw * mw).sum(axis=-1) / m_safe
                dof = 3.0 * (n - 1.0)
            else:
                kinetic = mw2 + carry["boost"]
                dof = 3.0 * n
            # k_B in u Å² ps⁻² K⁻¹ so that m[u] |v|²[Å²/ps²] / k_B
            # lands in kelvin; reduced units take k_B = 1
            k_B = (
                1.0
                if self._reduced
                else ureg.boltzmann_constant.m_as(
                    ureg.unified_atomic_mass_unit * ureg.angstrom**2
                    / ureg.picosecond**2 / ureg.kelvin
                )
            )
            self.results.temperature = np.where(
                dof > 0, kinetic / (dof * k_B), np.nan
            )

    def calculate_shear_rate(self, component: str = "x", *,
                             window=None) -> float:
        r"""Fit the shear rate :math:`\dot\gamma = \partial
        u_\alpha / \partial z` from the streaming-velocity profile
        (weighted linear least squares over the occupied bins).

        Parameters
        ----------
        component : `str`, default :code:`"x"`
            Velocity component whose gradient along the profiled
            axis is fitted.
        window : slice or array-like, keyword-only, optional
            Bin subset to fit (e.g. ``slice(10, 50)`` to exclude
            wall layers in a confined geometry).  Default: every
            occupied bin.

        Returns
        -------
        shear_rate : `float`
            :math:`\dot\gamma` in ps⁻¹ (stored with units in
            ``results.units`` unless reduced).
        """

        if component not in ("x", "y", "z"):
            raise ValueError("component must be 'x', 'y' or 'z'.")
        if getattr(self.results, "velocity", None) is None:
            raise RuntimeError("Call run() first.")
        comp = "xyz".index(component)
        bins = self.results.bins
        u = self.results.velocity[:, comp]
        counts = self.results.counts
        if window is not None:
            bins = bins[window]
            u = u[window]
            counts = counts[window]
        ok = np.isfinite(u) & (counts > 0)
        if ok.sum() < 2:
            raise ValueError(
                "Fewer than two occupied bins in the fit window."
            )
        # per-bin sample counts weight the fit (sparse bins carry
        # noisier velocity means)
        slope = np.polyfit(bins[ok], u[ok], 1, w=np.sqrt(counts[ok]))[0]
        self.results.shear_rate = float(slope)
        if not self._reduced:
            self.results.units["results.shear_rate"] = ureg.picosecond**-1
        return self.results.shear_rate
