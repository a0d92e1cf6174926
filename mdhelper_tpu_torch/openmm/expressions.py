r"""
Pair/bond energy expressions (OpenMM-free)
==========================================

The energy-expression strings, mixing rules, and per-particle parameter
tables of every custom potential factory, extracted into pure builders
so they are unit-testable without OpenMM installed (the factories in
:mod:`mdhelper_tpu_torch.openmm.pair` / ``bond`` consume them verbatim).

A copy of :mod:`mdhelper_tpu.openmm.expressions`.  The expressions are
those of the MDHelper package (the "reference" below: its
``openmm/pair.py`` for coul_gauss ``:266-268``, dpd ``:372``, gauss
``:522-524``, ljts/mie/wca ``:868-880``, solvation ``:1011`` and yukawa
``:1262-1264``, and ``openmm/bond.py:100-110`` for FENE).  The
reference's solvation factory concatenates the energy root and mixing
rule without the ``;`` statement separator (``pair.py:1020``); as in the
JAX package, the separator is kept here.
"""

import re
from typing import Optional, Sequence, Union

import numpy as np

__all__ = [
    "ewald_g",
    "pme_mesh_dimensions",
    "coul_gauss_energy",
    "dpd_energy",
    "gauss_energy",
    "ljts_energy",
    "solvation_energy",
    "yukawa_energy",
    "fene_energy",
]


def ewald_g(cutoff: float, tol: float) -> float:
    r"""Ewald splitting parameter :math:`g = \sqrt{-\ln 2\delta}/r_c`
    (reference ``openmm/pair.py:240-241``)."""

    return np.sqrt(-np.log(2 * tol)) / cutoff


def pme_mesh_dimensions(
    g_ewald: float, dims: np.ndarray, tol: float
) -> np.ndarray:
    r"""LAMMPS-style PME mesh rule
    :math:`n = \lceil 2 g L / (3\delta^{1/5})\rceil`
    (reference ``openmm/pair.py:640-642``)."""

    return np.ceil(2 * g_ewald * np.asarray(dims) / (3 * tol ** (1 / 5)))


def coul_gauss_energy(
    mix: str = "default", per_params: Optional[list] = None
) -> tuple[str, list]:
    """Smeared-Gaussian Coulomb direct-space expression
    (reference ``openmm/pair.py:259-268``)."""

    if mix == "default":
        mix = "alpha12=alpha1*alpha2/sqrt(alpha1^2+alpha2^2);"
        per_params = ["alpha"]
    elif mix == "core":
        mix = f"alpha12=sqrt({np.pi}/(2*(a1^2+a2^2)));"
        per_params = ["a"]
    return (
        "ONE_4PI_EPS0*q1*q2*(erf(alpha12*r)-erf(G_EWALD*r))/r;" + mix,
        list(per_params or []),
    )


def dpd_energy(cutoff_dpd: float, mix: Optional[str] = None) -> str:
    """Conservative DPD expression (reference ``openmm/pair.py:372``)."""

    energy = f"0.5*A12*{cutoff_dpd}*(1-r/{cutoff_dpd})^2;"
    if mix:
        energy += mix
    return energy


def gauss_energy(
    cutoff: float,
    cutoff_gauss: float,
    *,
    shift: bool = True,
    mix: str = "geometric",
    per_params: Optional[list] = None,
    known_globals: Sequence[str] = (),
) -> tuple[str, list]:
    """Gaussian repulsion expression with mixing rules
    (reference ``openmm/pair.py:522-535``)."""

    prefix = (
        f"step({cutoff_gauss}-r)*(" if cutoff != cutoff_gauss else "("
    )
    root = "alpha12*exp(-beta12*r^2)"
    suffix = (
        f"-ucut);ucut=alpha12*exp(-beta12*{cutoff_gauss}^2);"
        if shift
        else ");"
    )
    if mix == "arithmetic":
        mix = "alpha12=sqrt(alpha1*alpha2);beta12=2/(1/beta1+1/beta2);"
        per_params = ["alpha", "beta"]
    elif mix == "geometric":
        mix = "alpha12=sqrt(alpha1*alpha2);beta12=sqrt(beta1*beta2);"
        per_params = ["alpha", "beta"]
    elif "core" in mix:
        # The amplitude A must come from somewhere: a definition in
        # the user's own mixing statements or a registered global.
        # (Checked against the PRE-substitution string: the expansion
        # itself contains "A*", which would blind a post-hoc check.)
        if (
            re.search(r"\bA\s*=", mix) is None
            and "A" not in known_globals
        ):
            raise ValueError("Global parameter 'A' not specified.")
        mix = mix.replace(
            "core",
            f"alpha12=A*(beta12/{np.pi})^(3/2);"
            "beta12=3/(2*sigma12sq);sigma12sq=sigma1^2+sigma2^2",
        )
        if not mix.endswith(";"):
            mix += ";"
        per_params = list(per_params or []) + ["sigma"]
    return f"{prefix}{root}{suffix}{mix}", list(per_params or [])


def ljts_energy(
    cutoff: float,
    cutoff_ljts: float,
    *,
    coefs: Union[dict, tuple] = (1, 1, 4),
    powers: Union[dict, tuple] = (12, 6),
    shift: bool = True,
    mix: str = "arithmetic",
    mie: bool = False,
    wca: bool = False,
    per_params: Optional[list] = None,
) -> tuple[str, list]:
    """Truncated/shifted LJ, Mie, and WCA expressions with mixing rules
    (reference ``openmm/pair.py:860-899``)."""

    if mie and wca:
        raise ValueError("Both 'mie' and 'wca' are set to True.")
    if isinstance(powers, dict):
        powers = (powers["r"], powers["a"])
    if mie or wca:
        p, q = powers
        coef_mie = p / (p - q) * (p / q) ** (q / (p - q))

    if wca:
        cutoff_wca = (powers[0] / powers[1]) ** (
            1 / (powers[0] - powers[1])
        )
        root = (
            f"{coef_mie}*epsilon12*((sigma12/r)^{powers[0]}"
            f"-(sigma12/r)^{powers[1]})"
        )
        prefix = f"step({cutoff_wca}*sigma12-r)*("
        suffix = "+epsilon12);"
    else:
        if mie:
            coefs = (1, 1, coef_mie)
        elif isinstance(coefs, dict):
            coefs = (coefs["A"], coefs["B"], coefs["C"])
        root = (
            f"{coefs[2]}*epsilon12*({coefs[0]}*(sigma12/r)^{powers[0]}"
            f"-{coefs[1]}*(sigma12/r)^{powers[1]})"
        )
        prefix = (
            f"step({cutoff_ljts}-r)*("
            if cutoff != cutoff_ljts
            else "("
        )
        suffix = (
            f"-ucut);ucut={coefs[2]}*epsilon12*"
            f"({coefs[0]}*(sigma12/{cutoff_ljts})^{powers[0]}"
            f"-{coefs[1]}*(sigma12/{cutoff_ljts})^{powers[1]});"
            if shift
            else ");"
        )

    if mix == "arithmetic":
        mix = (
            "sigma12=(sigma1+sigma2)/2;"
            "epsilon12=sqrt(epsilon1*epsilon2);"
        )
        per_params = ["sigma", "epsilon"]
    elif mix == "geometric":
        mix = (
            "sigma12=sqrt(sigma1*sigma2);"
            "epsilon12=sqrt(epsilon1*epsilon2);"
        )
        per_params = ["sigma", "epsilon"]
    elif mix == "sixthpower":
        mix = (
            "sigma12=((sigma1^6+sigma2^6)/2)^(1/6);"
            "epsilon12=2*sqrt(epsilon1*epsilon2)*sigma1^3*sigma2^3"
            "/(sigma1^6+sigma2^6);"
        )
        per_params = ["sigma", "epsilon"]
    return f"{prefix}{root}{suffix}{mix}", list(per_params or [])


def solvation_energy(
    cutoff_solvation: float,
    *,
    mix: str = "arithmetic",
    per_params: Optional[list] = None,
) -> tuple[str, list]:
    """Attractive solvation expression (reference
    ``openmm/pair.py:1011-1016``; the reference omits the ``;`` between
    root and mixing rule — fixed here)."""

    root = "-S12*((sigma12/r)^4-(sigma12/cut)^4)"
    if mix == "arithmetic":
        mix = "sigma12=(sigma1+sigma2)/2;S12=sqrt(S1*S2);"
        per_params = ["sigma", "S"]
    elif mix == "geometric":
        mix = "sigma12=sqrt(sigma1*sigma2);S12=sqrt(S1*S2);"
        per_params = ["sigma", "S"]
    return f"{root};{mix}", list(per_params or [])


def yukawa_energy(
    cutoff: float,
    cutoff_yukawa: float,
    *,
    shift: bool = True,
    mix: str = "geometric",
    per_params: Optional[list] = None,
    known_globals: Sequence[str] = (),
) -> tuple[str, list]:
    """Yukawa (screened Coulomb) expression
    (reference ``openmm/pair.py:1262-1270``)."""

    prefix = (
        f"step({cutoff_yukawa}-r)*(" if cutoff != cutoff_yukawa else "("
    )
    root = "alpha12*exp(-kappa*r)/r"
    suffix = (
        f"-ucut);ucut=alpha12*exp(-kappa*{cutoff_yukawa})"
        f"/{cutoff_yukawa};"
        if shift
        else ");"
    )
    if "geometric" in mix:
        mix = mix.replace("geometric", "alpha12=sqrt(alpha1*alpha2)")
        if not mix.endswith(";"):
            mix += ";"
        if "kappa" not in mix and "kappa" not in known_globals:
            raise ValueError("Global parameter 'kappa' not defined.")
        per_params = list(per_params or []) + ["alpha"]
    return f"{prefix}{root}{suffix}{mix}", list(per_params or [])


def fene_energy() -> str:
    """FENE bond expression (reference ``openmm/bond.py:100``)."""

    return "-0.5*k*r0^2*log(1-(r/r0)^2)"
