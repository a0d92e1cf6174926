r"""
Custom OpenMM bond potentials
=============================

As in :mod:`mdhelper_tpu.openmm.bond`.  Requires OpenMM.
"""

from typing import Union

import openmm
from openmm import unit

from .expressions import fene_energy
from .pair import wca as _pair_wca

__all__ = ["fene"]


def _setup_bond(
    cbforce: openmm.CustomBondForce,
    global_params: dict,
    per_params: list,
) -> None:
    """Register global and per-bond parameters."""

    for name, value in (global_params or {}).items():
        cbforce.addGlobalParameter(name, value)
    for name in per_params or ():
        cbforce.addPerBondParameter(name)


def fene(
    global_args: dict = None,
    wca: bool = True,
    **kwargs,
) -> Union[
    openmm.CustomBondForce,
    tuple[openmm.CustomBondForce, openmm.CustomNonbondedForce],
]:
    r"""Finite extensible nonlinear elastic (FENE) bond

    .. math::

       u(r) = -\frac{k r_0^2}{2}\ln\left[1 -
       \left(\frac{r}{r_0}\right)^2\right]

    optionally paired with the WCA excluded-volume potential
    (the Kremer–Grest convention).

    Parameters named in `global_args` become global; the rest (``k``,
    ``r0``) stay per-bond.  Extra keyword arguments go to
    :func:`mdhelper_tpu_torch.openmm.pair.wca`.
    """

    global_args = global_args or {}
    bond = openmm.CustomBondForce(fene_energy())
    per_args = [p for p in ("k", "r0") if p not in global_args]
    _setup_bond(bond, global_args, per_args)
    if wca:
        return bond, _pair_wca(**kwargs)
    return bond
