r"""
Custom OpenMM pair potentials
=============================

Factory functions that return configured
``openmm.CustomNonbondedForce`` objects for pair potentials not built
into OpenMM, as in :mod:`mdhelper_tpu.openmm.pair`.  Named after their
LAMMPS ``pair_style`` counterparts where applicable.  Requires OpenMM.
"""

from typing import Union

import numpy as np
import openmm
from openmm import unit

from .expressions import (
    coul_gauss_energy,
    dpd_energy,
    ewald_g,
    gauss_energy,
    ljts_energy,
    pme_mesh_dimensions,
    solvation_energy,
    yukawa_energy,
)
from .unit import VACUUM_PERMITTIVITY

__all__ = [
    "coul_gauss",
    "dpd",
    "gauss",
    "lj_coul",
    "ljts",
    "solvation",
    "wca",
    "yukawa",
]


def _in_nm(value):
    """Strip an optional openmm length unit to nanometers."""

    if isinstance(value, unit.Quantity):
        return value.value_in_unit(unit.nanometer)
    return value


def _resolve_inner_cutoff(cutoff, inner, label: str):
    """Validate an optional potential-specific cutoff against the
    shared neighbor-list cutoff."""

    cutoff = _in_nm(cutoff)
    if inner is None:
        return cutoff, cutoff
    inner = _in_nm(inner)
    if inner > cutoff:
        raise ValueError(
            f"The cutoff distance for the {label} potential must be "
            "less than the shared cutoff distance."
        )
    return cutoff, inner


def _setup_pair(
    cnbforce: openmm.CustomNonbondedForce,
    cutoff,
    global_params: dict,
    per_params: list,
    tab_funcs: dict,
    method: int = None,
) -> None:
    """Register parameters, tabulated functions, and the cutoff on a
    custom nonbonded force."""

    if method is None:
        method = openmm.CustomNonbondedForce.CutoffPeriodic
    for name, value in (global_params or {}).items():
        cnbforce.addGlobalParameter(name, value)
    for name in per_params or ():
        cnbforce.addPerParticleParameter(name)
    for name, func in (tab_funcs or {}).items():
        if not isinstance(func, openmm.Discrete2DFunction):
            func = openmm.Discrete2DFunction(
                *func.shape, func.ravel().tolist()
            )
        cnbforce.addTabulatedFunction(name, func)
    cnbforce.setCutoffDistance(cutoff)
    cnbforce.setNonbondedMethod(method)


def coul_gauss(
    cutoff,
    tol: float = 1e-4,
    *,
    g_ewald=None,
    dims=None,
    mix: str = "default",
    per_params: list = None,
    global_params: dict = None,
    tab_funcs: dict = None,
):
    r"""Smeared-charge (Gaussian) Coulomb potential, Ewald-split into a
    real-space ``CustomNonbondedForce`` plus a reciprocal-space PME
    ``NonbondedForce``:

    .. math::

       u_\mathrm{dir}(r) = \frac{q_1 q_2}{4\pi\varepsilon_0 r}
       [\mathrm{erf}(\alpha_{12} r) - \mathrm{erf}(g_\mathrm{Ewald} r)]

    ``mix="default"`` combines the smearing parameters as
    :math:`\alpha_{12} = \alpha_1\alpha_2/\sqrt{\alpha_1^2+\alpha_2^2}`;
    ``mix="core"`` derives them from per-particle radii ``a``.

    Returns ``(direct_force, reciprocal_force)``.
    """

    if g_ewald is None:
        g_ewald = ewald_g(_in_nm(cutoff), tol)
    global_params = dict(global_params or {})
    global_params |= {
        "G_EWALD": g_ewald,
        "ONE_4PI_EPS0": unit.AVOGADRO_CONSTANT_NA
        / (4 * np.pi * VACUUM_PERMITTIVITY),
    }
    energy, per_params = coul_gauss_energy(mix, per_params)

    direct = openmm.CustomNonbondedForce(energy)
    direct.addPerParticleParameter("q")
    _setup_pair(direct, cutoff, global_params, per_params, tab_funcs)

    reciprocal = lj_coul(cutoff, tol, g_ewald=g_ewald, dims=dims)
    reciprocal.setIncludeDirectSpace(False)
    return direct, reciprocal


def dpd(
    cutoff,
    cutoff_dpd=None,
    *,
    mix: str = None,
    per_params: list = None,
    global_params: dict = None,
    tab_funcs: dict = None,
) -> openmm.CustomNonbondedForce:
    r"""Conservative dissipative-particle-dynamics potential

    .. math::

       u(r) = \frac{A_{12} r_\mathrm{c}}{2}
       \left(1 - \frac{r}{r_\mathrm{c}}\right)^2

    Provide the mixing rule for ``A12`` in `mix` (or ``A12`` as a global
    parameter).
    """

    cutoff, cutoff_dpd = _resolve_inner_cutoff(
        cutoff, cutoff_dpd, "dissipative particle dynamics (DPD)"
    )
    energy = dpd_energy(cutoff_dpd, mix)
    force = openmm.CustomNonbondedForce(energy)
    _setup_pair(force, cutoff, global_params, per_params, tab_funcs)
    return force


def gauss(
    cutoff,
    cutoff_gauss=None,
    *,
    shift: bool = True,
    mix: str = "geometric",
    global_params: dict = None,
    per_params: list = None,
    tab_funcs: dict = None,
) -> openmm.CustomNonbondedForce:
    r"""Gaussian repulsion
    :math:`u(r) = \alpha_{12}\exp(-\beta_{12} r^2)`, optionally shifted
    to zero at its cutoff.

    Mixing rules: ``"geometric"`` (both parameters geometric),
    ``"arithmetic"`` (harmonic beta), or a string containing ``"core"``
    which derives the prefactor from per-particle core sizes ``sigma`` and
    a global amplitude ``A``.
    """

    cutoff, cutoff_gauss = _resolve_inner_cutoff(
        cutoff, cutoff_gauss, "Gaussian"
    )
    energy, per_params = gauss_energy(
        cutoff, cutoff_gauss, shift=shift, mix=mix,
        per_params=per_params, known_globals=tuple(global_params or ()),
    )

    force = openmm.CustomNonbondedForce(energy)
    _setup_pair(force, cutoff, global_params, per_params, tab_funcs)
    return force


def lj_coul(
    cutoff,
    tol: float = 1e-4,
    *,
    g_ewald=None,
    dims=None,
) -> openmm.NonbondedForce:
    r"""Standard 12-6 Lennard-Jones + Coulomb ``NonbondedForce`` with
    PME electrostatics.

    With both `g_ewald` and `dims` given, the PME parameters are pinned via
    the LAMMPS-style mesh rule :math:`n = \lceil 2 g L /
    (3\,\mathrm{tol}^{1/5})\rceil`.
    """

    force = openmm.NonbondedForce()
    force.setCutoffDistance(cutoff)
    force.setNonbondedMethod(openmm.NonbondedForce.PME)
    if g_ewald is None or dims is None:
        force.setEwaldErrorTolerance(tol)
    else:
        n_mesh = pme_mesh_dimensions(g_ewald, dims, tol)
        force.setPMEParameters(g_ewald, *n_mesh)
    return force


def ljts(
    cutoff,
    cutoff_ljts=None,
    *,
    coefs: Union[dict, tuple] = (1, 1, 4),
    powers: Union[dict, tuple] = (12, 6),
    shift: bool = True,
    mix: str = "arithmetic",
    mie: bool = False,
    wca: bool = False,
    global_params: dict = None,
    per_params: list = None,
    tab_funcs: dict = None,
) -> openmm.CustomNonbondedForce:
    r"""Truncated (and optionally shifted) Lennard-Jones potential

    .. math::

       u(r) = C\,\epsilon_{12}\left[A\left(\frac{\sigma_{12}}{r}
       \right)^{p} - B\left(\frac{\sigma_{12}}{r}\right)^{q}\right]

    with Mie and WCA variants. Mixing rules: ``"arithmetic"``,
    ``"geometric"`` or ``"sixthpower"``.
    """

    cutoff, cutoff_ljts = _resolve_inner_cutoff(
        cutoff, cutoff_ljts, "LJTS"
    )
    energy, per_params = ljts_energy(
        cutoff, cutoff_ljts, coefs=coefs, powers=powers, shift=shift,
        mix=mix, mie=mie, wca=wca, per_params=per_params,
    )

    force = openmm.CustomNonbondedForce(energy)
    _setup_pair(force, cutoff, global_params, per_params, tab_funcs)
    return force


def solvation(
    cutoff,
    cutoff_solvation=None,
    *,
    mix: str = "arithmetic",
    per_params: list = None,
    global_params: dict = None,
    tab_funcs: dict = None,
) -> openmm.CustomNonbondedForce:
    r"""Attractive solvation potential

    .. math::

       u(r) = -S_{12}\left[\left(\frac{\sigma_{12}}{r}\right)^4
       - \left(\frac{\sigma_{12}}{r_\mathrm{cut}}\right)^4\right]

    The cutoff enters the energy expression as the global parameter
    ``cut``, registered automatically when absent from `global_params`
    (as in the JAX package; MDHelper's factory does not).
    """

    cutoff, cutoff_solvation = _resolve_inner_cutoff(
        cutoff, cutoff_solvation, "solvation"
    )
    energy, per_params = solvation_energy(
        cutoff_solvation, mix=mix, per_params=per_params
    )
    global_params = dict(global_params or {})
    global_params.setdefault("cut", cutoff_solvation)

    force = openmm.CustomNonbondedForce(energy)
    _setup_pair(force, cutoff, global_params, per_params, tab_funcs)
    return force


def wca(
    cutoff,
    *,
    mix: str = "arithmetic",
    powers: Union[dict, tuple] = (12, 6),
    global_params: dict = None,
    per_params: list = None,
    tab_funcs: dict = None,
) -> openmm.CustomNonbondedForce:
    r"""Weeks–Chandler–Andersen (purely repulsive LJ) potential."""

    return ljts(
        cutoff,
        powers=powers,
        mix=mix,
        wca=True,
        global_params=global_params,
        per_params=per_params,
        tab_funcs=tab_funcs,
    )


def yukawa(
    cutoff,
    cutoff_yukawa=None,
    *,
    shift: bool = True,
    mix: str = "geometric",
    per_params: list = None,
    global_params: dict = None,
    tab_funcs: dict = None,
) -> openmm.CustomNonbondedForce:
    r"""Yukawa (screened Coulomb) potential
    :math:`u(r) = \alpha_{12} e^{-\kappa r}/r`, optionally shifted.

    With a ``"geometric"`` mix, ``kappa`` must be supplied (in `mix` or
    `global_params`).
    """

    cutoff, cutoff_yukawa = _resolve_inner_cutoff(
        cutoff, cutoff_yukawa, "Yukawa"
    )
    energy, per_params = yukawa_energy(
        cutoff, cutoff_yukawa, shift=shift, mix=mix,
        per_params=per_params, known_globals=tuple(global_params or ()),
    )

    force = openmm.CustomNonbondedForce(energy)
    _setup_pair(force, cutoff, global_params, per_params, tab_funcs)
    return force
