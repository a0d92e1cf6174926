r"""
Thermodynamics
==============

Ported from :mod:`mdhelper_tpu.analysis.thermodynamics`: the
constant-volume heat capacity from energy fluctuations,

.. math::

   C_V = \frac{\langle U^2\rangle - \langle U\rangle^2}
   {k_\mathrm{B}T^2},

from LAMMPS or OpenMM logs or a raw energy series
(:class:`ConstantVolumeHeatCapacity`), and the Green-Kubo and
Einstein-Helfand transport coefficients of flux series
(:func:`calculate_shear_viscosity`,
:func:`calculate_thermal_conductivity`,
:func:`calculate_ionic_conductivity`) on the port's float64
:func:`~mdhelper_tpu_torch.algorithm.correlation.correlation_fft` and
:func:`~mdhelper_tpu_torch.algorithm.correlation.msd_fft`, run on
the first CUDA device unless the caller passes ``device=`` (``"cpu"``
for the CPU).

The JAX package reads the logs with pandas, which the machine with the
card does not have; the port parses them itself (:func:`_read_table`)
and keeps pandas' column names, its row sums (column after column,
missing values as 0) and its mean.  Its numbers are Python's correctly
rounded ``float``; pandas' default C parser rounds some 17-digit fields
(the shortest round-trip form OpenMM writes) one unit in the last place
off, which then differs between the packages (ROADMAP Queue 3).
"""

import csv
import re
import warnings
from pathlib import Path
from typing import Union

import numpy as np
import torch

from .. import Q_, ureg
from .._device import resolve_device
from ..algorithm.correlation import _host, correlation_fft, msd_fft
from ..algorithm.unit import strip_unit
from .base import Hash

__all__ = [
    "ConstantVolumeHeatCapacity",
    "calculate_ionic_conductivity",
    "calculate_shear_viscosity",
    "calculate_thermal_conductivity",
]


class _Table:
    """The columns of a parsed log: ``table[name]`` is the float64 column
    (parsed when read, so a column of text the analysis never reads does
    not fail), missing fields NaN; a repeated name reads its first
    column, as pandas' indexing does."""

    def __init__(self, names, rows):
        self._names = names
        self._rows = rows

    def __getitem__(self, name):
        if name not in self._names:
            raise KeyError(name)
        j = self._names.index(name)
        values = np.empty(len(self._rows))
        for i, row in enumerate(self._rows):
            field = row[j].strip() if j < len(row) else ""
            try:
                values[i] = float(field) if field else np.nan
            except ValueError:
                raise ValueError(
                    f"Column '{name}' holds '{field}', not a number."
                ) from None
        return values

    def row_sums(self, names) -> np.ndarray:
        """Row sums of the columns `names`, added column after column with
        missing values as 0 (``DataFrame.sum(axis=1)``)."""

        total = None
        for name in names:
            column = np.nan_to_num(self[name], nan=0.0, posinf=np.inf,
                                   neginf=-np.inf)
            total = column if total is None else total + column
        return total

    def mean(self, name) -> float:
        """The mean of a column's values, missing ones left out
        (``Series.mean()``: the sum with zeros in their place over the
        count)."""

        column = self[name]
        present = ~np.isnan(column)
        return np.where(present, column, 0.0).sum() / present.sum()


def _read_table(text: str, sep=None) -> _Table:
    """A delimited table: the first non-blank line names the columns, each
    further non-blank line is a row.  ``sep=None`` splits on runs of
    whitespace; one character is a ``csv`` delimiter (quoted fields lose
    their quotes, so OpenMM's ``#"Step"`` keeps its own); a longer `sep` is
    a regular expression, as pandas reads it.  A row with more fields than
    the header raises."""

    lines = [line for line in text.split("\n") if line.strip()]
    if sep is None:
        records = [line.split() for line in lines]
    elif len(sep) == 1:
        records = list(csv.reader(lines, delimiter=sep))
    else:
        records = [re.split(sep, line) for line in lines]
    if not records:
        raise ValueError("No thermodynamic data found.")
    names, rows = records[0], records[1:]
    for i, row in enumerate(rows):
        if len(row) > len(names):
            raise ValueError(
                f"Expected {len(names)} fields in row {i + 1}, saw "
                f"{len(row)}."
            )
    return _Table(names, rows)


class ConstantVolumeHeatCapacity:
    r"""Constant-volume heat capacity :math:`C_V` from total-energy
    fluctuations.

    LAMMPS and OpenMM logs with the JAX package's column-priority rules
    (total energy, else kinetic + potential, else kinetic + per-term
    sums), temperature from the log's mean or given explicitly, and
    reduced units.  The log is parsed without pandas (see the module).

    Parameters
    ----------
    log_file : `str` or `Path`, optional
        LAMMPS or OpenMM log/state-data file.
    log_format : `str`, optional
        ``"lammps"`` or ``"openmm"`` (auto-detected if omitted).
    energies : array-like, keyword-only, optional
        Raw total-energy series (kJ/mol) instead of a log file.
    temperature : `float`, keyword-only, optional
        System temperature (K); defaults to the log's mean temperature.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units.
    sep : `str`, keyword-only, default ``","``
        Column separator for OpenMM state-data files.
    """

    _COLUMNS = {
        "lammps": {
            "energy": [
                "TotEng", "KinEng", "PotEng", "E_angle", "E_bond",
                "E_coul", "E_dihed", "E_impro", "E_long", "E_vdwl",
            ],
            "temperature": "Temp",
        },
        "openmm": {
            "energy": [
                "Total Energy (kJ/mole)",
                "Kinetic Energy (kJ/mole)",
                "Potential Energy (kJ/mole)",
            ],
            "temperature": "Temperature (K)",
        },
    }

    def __init__(
        self,
        log_file: Union[str, Path] = None,
        log_format: str = None,
        *,
        energies=None,
        temperature: Union[float, Q_] = None,
        reduced: bool = False,
        sep: str = ",",
    ) -> None:
        self.results = Hash(units={})
        self._reduced = reduced
        table = None

        if energies is not None:
            self.results.units["results.energies"] = (
                ureg.kilojoule / ureg.mole
            )
            self.results.units["results.heat_capacity"] = (
                ureg.kilojoule / ureg.kelvin
            )
            self.results.energies = np.asarray(
                strip_unit(
                    energies, self.results.units["results.energies"]
                )[0]
            )
        elif log_file:
            self._file = Path(log_file)
            with open(self._file) as f:
                log = f.read()

            if log_format is None:
                for fmt, cols in self._COLUMNS.items():
                    if any(c in log for c in cols["energy"]):
                        log_format = fmt
                        break
                else:
                    raise ValueError("Could not determine log file format.")
            self._format = log_format

            if self._format == "lammps":
                if "minimize" in log:
                    log = log[log.index("Minimization stats:"):]
                lines = log.split("\n")
                for i, line in enumerate(lines):
                    if "Step" in line:
                        lines = lines[i:]
                        break
                else:
                    raise ValueError(
                        "No thermodynamic data found in log file "
                        f"'{log_file}'."
                    )
                log = "\n".join(lines)
                if "Loop time of " in log:
                    log = log[:log.index("Loop time of ")]
                table_sep = None
                self.results.units["results.energies"] = (
                    ureg.kilocalorie / ureg.mole
                )
                self.results.units["results.heat_capacity"] = (
                    ureg.kilocalorie / ureg.kelvin
                )
            elif self._format == "openmm":
                table_sep = sep
                if reduced:
                    warnings.warn("OpenMM simulations always use real units.")
                self.results.units["results.energies"] = (
                    ureg.kilojoule / ureg.mole
                )
                self.results.units["results.heat_capacity"] = (
                    ureg.kilojoule / ureg.kelvin
                )
            else:
                raise ValueError(f"Invalid log format '{log_format}'.")

            catalog = self._COLUMNS[self._format]["energy"]
            if catalog[0] in log:
                cols = catalog[:1]
            elif catalog[1] in log:
                cols = catalog[1:2]
                if catalog[2] in log:
                    cols.append(catalog[2])
                elif any(e in log for e in catalog[3:]):
                    cols.extend(e for e in catalog[3:] if e in log)
                else:
                    raise ValueError("Potential energy column not found.")
            else:
                raise ValueError("Total or kinetic energy column not found.")

            table = _read_table(log, table_sep)
            self.results.energies = table.row_sums(cols)
        else:
            raise ValueError("No log file or energy values provided.")

        if temperature is not None:
            self.temperature, unit_ = strip_unit(temperature)
            self.results.units["temperature"] = (
                ureg.kelvin if unit_ is None else unit_
            )
        elif table is None:
            raise ValueError("No log file or temperature value provided.")
        else:
            self.temperature = table.mean(
                self._COLUMNS[self._format]["temperature"]
            )
            self.results.units["temperature"] = ureg.kelvin

    def run(
        self,
        start: int = None,
        stop: int = None,
        step: int = None,
        frames=None,
    ) -> "ConstantVolumeHeatCapacity":
        """Compute :math:`C_V` over the selected energy samples."""

        if frames is None:
            frames = np.arange(
                start or 0,
                stop if stop is not None else len(self.results.energies),
                step,
            )
        U = self.results.energies[frames]
        if self._reduced:
            self.results.heat_capacity = (
                (U**2).mean() - U.mean() ** 2
            ) / self.temperature**2
        else:
            Uq = U * self.results.units["results.energies"]
            self.results.heat_capacity = strip_unit(
                ((Uq**2).mean() - Uq.mean() ** 2)
                / (
                    ureg.avogadro_constant**2
                    * ureg.boltzmann_constant
                    * (self.temperature * self.results.units["temperature"])
                    ** 2
                ),
                self.results.units["results.heat_capacity"],
            )[0]
        return self


def calculate_shear_viscosity(
    pressures,
    volume: float,
    temperature: float,
    dt: float,
    *,
    method: str = "green-kubo",
    fit_interval: tuple = (0.01, 0.1),
    reduced: bool = False,
    device=None,
) -> Hash:
    r"""Shear viscosity from off-diagonal pressure-tensor fluctuations.

    ``method="green-kubo"`` (default) integrates the stress ACF,

    .. math::

       \eta = \frac{V}{k_\mathrm{B}T} \int_0^\infty \langle
       P_{\alpha\beta}(0)\,P_{\alpha\beta}(t)\rangle\,dt,

    averaged over the supplied components and returned with its running
    (cumulative-trapezoid) integral.  ``method="einstein"`` takes the
    Einstein-Helfand form, the slope of the mean-squared displacement of
    the Helfand moment :math:`G_{\alpha\beta}(t) = \int_0^t
    P_{\alpha\beta}\,dt'`,

    .. math::

       \eta = \frac{V}{2 k_\mathrm{B}T} \lim_{t\to\infty}
       \frac{d}{dt} \bigl\langle [G_{\alpha\beta}(t_0 + t) -
       G_{\alpha\beta}(t_0)]^2 \bigr\rangle_{t_0},

    fit linearly over the fractional lag window `fit_interval`.

    Parameters
    ----------
    pressures : array-like
        Off-diagonal pressure series, shape ``(N_t,)`` or ``(N_t, C)``
        (components averaged), in atmospheres, or a full ``(N_t, 3, 3)``
        tensor series (its three off-diagonal components are taken).  LJ
        pressure units when ``reduced=True``.
    volume : `float`
        System volume (Angstrom^3; LJ volume when reduced).
    temperature : `float`
        Temperature (K), or the LJ energy scale when reduced.
    dt : `float`
        Series time step (ps; LJ time when reduced).
    method : `str`, keyword-only, default ``"green-kubo"``
        ``"green-kubo"`` or ``"einstein"``.
    fit_interval : `tuple`, keyword-only, default ``(0.01, 0.1)``
        Einstein-Helfand only: fractional ``(start, stop)`` of the lag
        window of the slope fit.
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units.
    device : `torch.device` or `str`, keyword-only, optional
        Where the FFTs run (default: the first CUDA device; raises
        `RuntimeError` without one).  Pass ``"cpu"`` for the CPU.

    Returns
    -------
    results : `Hash`
        Green-Kubo: ``times`` (ps), ``acf`` ((atm)^2), ``running_viscosity``
        and ``viscosity`` (mPa s), and ``units`` (omitted when reduced).
        Einstein-Helfand: ``times``, ``helfand_msd`` ((atm ps)^2),
        ``running_viscosity`` (the half-derivative of the Helfand MSD),
        ``viscosity`` (the slope's), and ``units``.
    """

    if method not in ("green-kubo", "einstein"):
        raise ValueError(
            f"Invalid method: {method!r}. Valid values: "
            "'green-kubo', 'einstein'."
        )
    lo_frac, hi_frac = fit_interval
    if not (0.0 <= lo_frac < hi_frac <= 1.0):
        raise ValueError(
            "fit_interval must be an increasing (start, stop) "
            f"fraction pair within [0, 1]; got {fit_interval!r}."
        )

    pressures, _ = strip_unit(pressures, "atmosphere")
    pressures = np.asarray(pressures, dtype=np.float64)
    if pressures.ndim == 3:
        if pressures.shape[1:] != (3, 3):
            raise ValueError("A tensor series must have shape (N_t, 3, 3).")
        pressures = np.stack(
            [pressures[:, 0, 1], pressures[:, 0, 2], pressures[:, 1, 2]],
            axis=-1,
        )
    elif pressures.ndim == 1:
        pressures = pressures[:, None]
    elif pressures.ndim != 2:
        raise ValueError(
            "pressures must have shape (N_t,), (N_t, C) or (N_t, 3, 3)."
        )
    volume, _ = strip_unit(volume, "angstrom**3")
    temperature, _ = strip_unit(temperature, "kelvin")
    dt, _ = strip_unit(dt, "picosecond")

    if reduced:
        scale = volume / temperature
    else:
        scale = (
            (
                1
                * ureg.atmosphere**2
                * ureg.angstrom**3
                * ureg.picosecond
                / (ureg.boltzmann_constant * ureg.kelvin)
            )
            .to("millipascal * second")
            .magnitude
            * volume
            / temperature
        )

    if method == "einstein":
        # The Helfand moment (cumulative trapezoid), one column a
        # component; its component-averaged MSD by FFT.
        helfand = np.concatenate(
            (
                np.zeros((1, pressures.shape[1])),
                np.cumsum(dt * (pressures[1:] + pressures[:-1]) / 2, axis=0),
            )
        )
        msd = _scalar_msd_fft(helfand, device)
        times = np.arange(len(msd)) * dt
        running = scale * 0.5 * np.gradient(msd, dt)
        lo = int(round(fit_interval[0] * len(msd)))
        hi = int(round(fit_interval[1] * len(msd)))
        lo = max(1, lo)
        hi = max(lo + 2, hi)
        slope = np.polyfit(times[lo:hi], msd[lo:hi], 1)[0]
        results = Hash(
            times=times,
            helfand_msd=msd,
            running_viscosity=running,
            viscosity=float(scale * 0.5 * slope),
        )
        if not reduced:
            results.units = Hash(
                times=ureg.picosecond,
                helfand_msd=(ureg.atmosphere * ureg.picosecond) ** 2,
                running_viscosity=ureg.millipascal * ureg.second,
                viscosity=ureg.millipascal * ureg.second,
            )
        return results

    times, acf, integral = _green_kubo_running(pressures, dt, device)
    results = Hash(
        times=times,
        acf=acf,
        running_viscosity=scale * integral,
        viscosity=float(scale * integral[-1]),
    )
    if not reduced:
        results.units = Hash(
            times=ureg.picosecond,
            acf=ureg.atmosphere**2,
            running_viscosity=ureg.millipascal * ureg.second,
            viscosity=ureg.millipascal * ureg.second,
        )
    return results


def _on_device(series: np.ndarray, device) -> torch.Tensor:
    """A float64 host series on `device` (:func:`resolve_device`)."""

    return torch.as_tensor(series, dtype=torch.float64,
                           device=resolve_device(device))


def _scalar_msd_fft(series: np.ndarray, device) -> np.ndarray:
    """Component-averaged mean-squared displacement of a scalar ``(N_t,
    C)`` series (each column a one-component particle), float64, by FFT
    on `device`."""

    return _host(msd_fft(_on_device(series[:, :, None], device), axis=0))


def _green_kubo_running(series: np.ndarray, dt: float, device):
    """Component-averaged ACF of a ``(N_t,)`` or ``(N_t, C)`` series by FFT
    on `device` and its cumulative-trapezoid running integral."""

    if series.ndim == 1:
        series = series[:, None]
    elif series.ndim != 2:
        raise ValueError("The flux series must have shape (N_t,) or (N_t, C).")
    acf = _host(correlation_fft(_on_device(series, device), axis=0,
                                average=True))
    times = np.arange(len(acf)) * dt
    integral = np.concatenate(
        ([0.0], np.cumsum((acf[1:] + acf[:-1]) / 2) * dt)
    )
    return times, acf, integral


def calculate_thermal_conductivity(
    heat_flux,
    volume: float,
    temperature: float,
    dt: float,
    *,
    reduced: bool = False,
    device=None,
) -> Hash:
    r"""Green-Kubo thermal conductivity from heat-flux fluctuations,

    .. math::

       \lambda = \frac{V}{k_\mathrm{B}T^2} \int_0^\infty \langle
       J_\alpha(0)\,J_\alpha(t)\rangle\,dt,

    averaged over the supplied components, with its running integral.

    Parameters
    ----------
    heat_flux : array-like
        Heat-flux (per volume) series, shape ``(N_t, 3)`` or ``(N_t,)``,
        in kcal/(mol Angstrom^2 ps) (LAMMPS real-units ``compute
        heat/flux`` output over the cell volume); LJ flux units when
        ``reduced=True``.
    volume : `float`
        System volume (Angstrom^3; LJ volume when reduced).
    temperature : `float`
        Temperature (K), or the LJ energy scale when reduced.
    dt : `float`
        Series time step (ps; LJ time when reduced).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units.
    device : `torch.device` or `str`, keyword-only, optional
        Where the FFTs run (default: the first CUDA device; raises
        `RuntimeError` without one).  Pass ``"cpu"`` for the CPU.

    Returns
    -------
    results : `Hash`
        ``times`` (ps), ``acf`` (component-averaged),
        ``running_conductivity``/``conductivity`` (W/(m K)), and ``units``
        (omitted when reduced).
    """

    heat_flux = np.asarray(
        strip_unit(
            heat_flux, "kilocalorie / mole / angstrom**2 / picosecond"
        )[0],
        dtype=np.float64,
    )
    volume, _ = strip_unit(volume, "angstrom**3")
    temperature, _ = strip_unit(temperature, "kelvin")
    dt, _ = strip_unit(dt, "picosecond")
    times, acf, integral = _green_kubo_running(heat_flux, dt, device)
    if reduced:
        scale = volume / temperature**2
        return Hash(
            times=times,
            acf=acf,
            running_conductivity=scale * integral,
            conductivity=float(scale * integral[-1]),
        )
    flux_unit = ureg.kilocalorie / ureg.mole / (
        ureg.angstrom**2 * ureg.picosecond
    )
    scale = (
        (
            (1 * flux_unit / ureg.avogadro_constant) ** 2
            * ureg.angstrom**3
            * ureg.picosecond
            / (ureg.boltzmann_constant * ureg.kelvin**2)
        )
        .to("watt / (meter * kelvin)")
        .magnitude
        * volume
        / temperature**2
    )
    wmk = ureg.watt / (ureg.meter * ureg.kelvin)
    return Hash(
        times=times,
        acf=acf,
        running_conductivity=scale * integral,
        conductivity=float(scale * integral[-1]),
        units=Hash(
            times=ureg.picosecond,
            acf=flux_unit**2,
            running_conductivity=wmk,
            conductivity=wmk,
        ),
    )


def calculate_ionic_conductivity(
    current,
    volume: float,
    temperature: float,
    dt: float,
    *,
    reduced: bool = False,
    device=None,
) -> Hash:
    r"""Green-Kubo ionic conductivity from charge-current fluctuations,

    .. math::

       \sigma = \frac{1}{3 V k_\mathrm{B}T} \int_0^\infty \langle
       \mathbf{J}(0)\cdot\mathbf{J}(t)\rangle\,dt,
       \qquad \mathbf{J}(t) = \sum_i q_i\,\mathbf{v}_i(t),

    as the component-averaged ACF with its running integral.

    Parameters
    ----------
    current : array-like
        Total charge-current series, shape ``(N_t, 3)`` or ``(N_t,)``, in
        e Angstrom/ps; LJ units when ``reduced=True``.
    volume : `float`
        System volume (Angstrom^3; LJ volume when reduced).
    temperature : `float`
        Temperature (K), or the LJ energy scale when reduced.
    dt : `float`
        Series time step (ps; LJ time when reduced).
    reduced : `bool`, keyword-only, default False
        Reduced (LJ) units.
    device : `torch.device` or `str`, keyword-only, optional
        Where the FFTs run (default: the first CUDA device; raises
        `RuntimeError` without one).  Pass ``"cpu"`` for the CPU.

    Returns
    -------
    results : `Hash`
        ``times`` (ps), ``acf`` ((e Angstrom/ps)^2), ``running_conductivity``
        / ``conductivity`` (S/m), and ``units`` (omitted when reduced).
    """

    current = np.asarray(
        strip_unit(current, "elementary_charge * angstrom / picosecond")[0],
        dtype=np.float64,
    )
    if current.ndim == 2 and current.shape[1] not in (1, 3):
        raise ValueError(
            "current must have shape (N_t,), (N_t, 1) or (N_t, 3)."
        )
    volume, _ = strip_unit(volume, "angstrom**3")
    temperature, _ = strip_unit(temperature, "kelvin")
    dt, _ = strip_unit(dt, "picosecond")
    times, acf, integral = _green_kubo_running(current, dt, device)
    if reduced:
        scale = 1.0 / (volume * temperature)
        return Hash(
            times=times,
            acf=acf,
            running_conductivity=scale * integral,
            conductivity=float(scale * integral[-1]),
        )
    current_unit = ureg.elementary_charge * ureg.angstrom / ureg.picosecond
    scale = (
        (
            1
            * current_unit**2
            * ureg.picosecond
            / (ureg.angstrom**3 * ureg.boltzmann_constant * ureg.kelvin)
        )
        .to("siemens / meter")
        .magnitude
        / (volume * temperature)
    )
    sm = ureg.siemens / ureg.meter
    return Hash(
        times=times,
        acf=acf,
        running_conductivity=scale * integral,
        conductivity=float(scale * integral[-1]),
        units=Hash(
            times=ureg.picosecond,
            acf=current_unit**2,
            running_conductivity=sm,
            conductivity=sm,
        ),
    )
