r"""
OpenMM system extensions
========================

System-level tools for pseudo-2D slab systems: the Yeh–Berkowitz slab
correction, the method of image charges, applied electric fields, and
a finite-difference pressure-tensor estimator, as in
:mod:`mdhelper_tpu.openmm.system`.  Requires OpenMM, apart from the
image-charge lattice sums (:func:`_ic_beta`, which need mpmath).

The image-charge integrator comes from the ``openmm_ic`` plugin (this
repository ships its C++ sources under ``lib/openmm-ic-plugin``) or,
as a fallback, the ``constvplugin`` package.
"""

from __future__ import annotations

import logging
from typing import Any, Union
import warnings

import numpy as np

try:
    import openmm
    from openmm import app, unit
except ImportError:  # pragma: no cover
    openmm = app = unit = None
from scipy import special

try:
    import mpmath

    FOUND_MPMATH = True
except ImportError:  # pragma: no cover
    FOUND_MPMATH = False

from .unit import VACUUM_PERMITTIVITY

try:
    from openmm_ic import ICLangevinIntegrator

    FOUND_ICPLUGIN = True
except ImportError:
    try:
        from constvplugin import (
            ConstVLangevinIntegrator as ICLangevinIntegrator,
        )

        FOUND_ICPLUGIN = True
    except ImportError:
        ICLangevinIntegrator = None
        FOUND_ICPLUGIN = False

__all__ = [
    "register_particles",
    "add_slab_correction",
    "add_image_charges",
    "add_electric_field",
    "estimate_pressure_tensor",
]


def _require_openmm() -> None:
    if openmm is None:
        raise ImportError(
            "OpenMM is required for this function. Only the pure-math "
            "helpers (e.g. the image-charge lattice sums) work "
            "without it."
        )


def _particle_charges(force, charge_index: int) -> np.ndarray:
    """Per-particle charge numbers from a (custom) nonbonded force."""

    def strip(value):
        if isinstance(value, unit.Quantity):
            return value.value_in_unit(unit.elementary_charge)
        return value

    return np.fromiter(
        (
            strip(force.getParticleParameters(i)[charge_index])
            for i in range(force.getNumParticles())
        ),
        dtype=float,
    )


def register_particles(
    system: openmm.System,
    topology: "app.Topology",
    N: int = 0,
    mass=0.0,
    *,
    chain=None,
    element=None,
    name: str = "",
    resname: str = "",
    nbforce=None,
    charge=0.0,
    sigma=0.0,
    epsilon=0.0,
    cnbforces: dict = None,
) -> None:
    r"""Add `N` identical particles to a system, its topology, and the
    given force objects in one pass.

    Without an explicit `chain`, each particle gets its own chain
    (nonbonded entities).
    """

    _require_openmm()

    cnbforces = cnbforces or {}
    own_chain = chain is None
    for _ in range(N):
        if system is not None:
            system.addParticle(mass)
        if own_chain:
            chain = topology.addChain()
        residue = topology.addResidue(resname or name, chain)
        topology.addAtom(name, element, residue)
        if nbforce is not None:
            nbforce.addParticle(charge, sigma, epsilon)
        for force, params in cnbforces.items():
            force.addParticle(params)


def add_slab_correction(
    system: openmm.System,
    topology: "app.Topology",
    nbforce,
    temp,
    fric,
    dt,
    axis: int = 2,
    *,
    charge_index: int = 0,
    z_scale: float = 3,
    method: str = "force",
) -> openmm.Integrator:
    r"""Apply the Yeh–Berkowitz slab correction for 2D-periodic
    electrostatics: scale the box along `axis` and add the dipole
    correction energy

    .. math::

       U_\mathrm{corr} = \frac{N_\mathrm{A}}{2\varepsilon_0 V}
       \left(M_z^2 - q_\mathrm{tot}\langle q z^2\rangle
       - \frac{q_\mathrm{tot}^2 L_z^2}{12}\right)

    via a ``CustomCVForce`` (``method="force"``) or a custom Langevin
    integrator that recomputes the dipole sums each step
    (``method="integrator"``).

    Returns the integrator to use with the corrected system.
    """

    _require_openmm()

    dims = (
        np.array(
            topology.getUnitCellDimensions().value_in_unit(
                unit.nanometer
            )
        )
        * unit.nanometer
    )
    pbv = system.getDefaultPeriodicBoxVectors()
    if z_scale < 2:
        warnings.warn(
            "A z-scaling factor that is less than 2 may introduce "
            "unwanted slab-slab interactions. The recommended value "
            "is 3."
        )
    elif z_scale > 5:
        warnings.warn(
            "A z-scaling factor that is greater than 5 may penalize "
            "performance. The recommended value is 3."
        )
    dims[axis] *= z_scale
    pbv[axis] *= z_scale
    topology.setUnitCellDimensions(dims)
    system.setDefaultPeriodicBoxVectors(*pbv)

    qs = _particle_charges(nbforce, charge_index)
    neutral_particles = qs.min() == qs.max()
    if neutral_particles:
        return openmm.LangevinMiddleIntegrator(temp, fric, dt)

    q_tot = qs.sum()
    electroneutral = np.isclose(q_tot, 0)
    coef = unit.AVOGADRO_CONSTANT_NA / (
        2 * VACUUM_PERMITTIVITY * dims[0] * dims[1] * dims[2]
    )
    z = chr(120 + axis)

    if method == "integrator":
        integrator = openmm.CustomIntegrator(dt)
        integrator.addGlobalVariable("a", np.exp(-fric * dt))
        integrator.addGlobalVariable(
            "b", np.sqrt(1 - np.exp(-2 * fric * dt))
        )
        integrator.addGlobalVariable(
            "kT",
            unit.AVOGADRO_CONSTANT_NA
            * unit.BOLTZMANN_CONSTANT_kB
            * temp,
        )
        integrator.addPerDofVariable("x1", 0)
        integrator.addUpdateContextState()
        integrator.addComputePerDof("v", "v+dt*f/m")
        integrator.addConstrainVelocities()
        integrator.addComputePerDof("x", "x+dt*v/2")
        integrator.addComputePerDof("v", "a*v+b*sqrt(kT/m)*gaussian")
        integrator.addComputePerDof("x", "x+dt*v/2")
        integrator.addComputePerDof("x1", "x")
        integrator.addConstrainPositions()
        integrator.addComputePerDof("v", "v+(x-x1)/dt")
        integrator.addPerDofVariable("q", 0)
        integrator.addComputeSum("M_z", "q*x")
        integrator.addComputeSum("M_zz", "q*x^2")
        q_vectors = np.zeros((len(qs), 3))
        q_vectors[:, axis] = qs
        integrator.setPerDofVariableByName("q", q_vectors)

        if electroneutral:
            slab_corr = openmm.CustomExternalForce(
                f"coef*q*({z}*M_z-M_zz/2)"
            )
        else:
            slab_corr = openmm.CustomExternalForce(
                f"coef*q*({z}*M_z-(M_zz+q_tot*{z}^2)/2"
                f"-q_tot*dim_z^2/12)"
            )
            slab_corr.addGlobalParameter("dim_z", dims[axis])
            slab_corr.addGlobalParameter("q_tot", q_tot)
        slab_corr.addGlobalParameter("M_z", 0)
        slab_corr.addGlobalParameter("M_zz", 0)
        slab_corr.addGlobalParameter("coef", coef)
        slab_corr.addPerParticleParameter("q")
        for i, q in enumerate(qs):
            slab_corr.addParticle(i, (q,))
    elif method == "force":
        integrator = openmm.LangevinMiddleIntegrator(temp, fric, dt)
        cv_mz = openmm.CustomExternalForce(f"q*{z}")
        cv_mz.addPerParticleParameter("q")
        if electroneutral:
            slab_corr = openmm.CustomCVForce("coef*M_z^2")
        else:
            cv_mzz = openmm.CustomExternalForce(f"q*{z}^2")
            cv_mzz.addPerParticleParameter("q")
            slab_corr = openmm.CustomCVForce(
                "coef*(M_z^2-q_tot*M_zz-q_tot^2*dim_z^2/12)"
            )
            slab_corr.addCollectiveVariable("M_zz", cv_mzz)
            slab_corr.addGlobalParameter("dim_z", dims[axis])
            slab_corr.addGlobalParameter("q_tot", q_tot)
        slab_corr.addCollectiveVariable("M_z", cv_mz)
        slab_corr.addGlobalParameter("coef", coef)
        for i, q in enumerate(qs):
            cv_mz.addParticle(i, (q,))
            if not electroneutral:
                cv_mzz.addParticle(i, (q,))
    else:
        raise ValueError(
            "Invalid method. Valid values: 'force', 'integrator'."
        )

    system.addForce(slab_corr)
    return integrator


def _ic_beta(gamma: float, x: float) -> float:
    r"""Lattice sum :math:`\beta(\gamma, x)` entering the higher-order
    image-charge correction (Hurwitz zeta / Lerch phi combination)."""

    if not 0 <= x <= 1:
        raise ValueError("'x' must be between 0 and 1.")
    if not FOUND_MPMATH:  # pragma: no cover
        raise ImportError(
            "mpmath is required for gamma != -1 image-charge "
            "corrections."
        )
    if np.isclose(x, 0.5):
        return float(
            2 * special.zeta(3, 1.5)
            - 2 * gamma**4 * mpmath.lerchphi(gamma**2, 3, 1.5)
        )
    return (
        special.zeta(2, 2 - x)
        - special.zeta(2, 1 + x)
        - gamma**4
        * float(
            mpmath.lerchphi(gamma**2, 2, 2 - x)
            - mpmath.lerchphi(gamma**2, 2, 1 + x)
        )
    ) / (2 * x - 1)


def add_image_charges(
    system: openmm.System,
    topology: "app.Topology",
    positions,
    temp,
    fric,
    dt,
    *,
    gamma: float = -1,
    n_cells: int = 2,
    nbforce=None,
    cnbforces: dict = None,
    wall_indices: np.ndarray = None,
    exclude: bool = False,
):
    r"""Set up the method of image charges for constant-potential
    electrode simulations: mirror every particle across the electrode
    plane(s), register the image particles (with charges scaled by
    :math:`\gamma`) in the system/topology/forces, add higher-order
    dielectric-contrast corrections for :math:`\gamma \neq \pm 1`, and
    return the image-charge Langevin integrator that re-mirrors image
    positions every step.

    Returns ``(positions_with_images, ICLangevinIntegrator)``.
    """

    _require_openmm()

    if not FOUND_ICPLUGIN:
        raise ImportError(
            "An integrator capable of simulating a system with image "
            "charges was not found. Build the openmm-ic plugin under "
            "lib/openmm-ic-plugin (or install constvplugin) to use "
            "the method of image charges."
        )
    if np.isclose(gamma, 0):
        raise ValueError(
            "Use the slab correction, available via "
            "mdhelper_tpu_torch.openmm.system.add_slab_correction(), for "
            "gamma=0."
        )
    if not np.isclose(gamma, -1) and n_cells != 2:
        raise ValueError(
            "The method of image charges with gamma != -1 is only "
            "implemented for n_cells=2."
        )

    cnbforces = cnbforces or {}
    dims = (
        np.asarray(
            topology.getUnitCellDimensions().value_in_unit(
                unit.nanometer
            )
        )
        * unit.nanometer
    )
    pbv = system.getDefaultPeriodicBoxVectors()
    n_real = positions.shape[0]
    if isinstance(positions, unit.Quantity):
        positions = positions.value_in_unit(unit.nanometer)

    if wall_indices is None:
        lz = dims[2].value_in_unit(unit.nanometer)
        wall_indices = np.concatenate(
            (
                np.isclose(positions[:, 2], 0).nonzero()[0],
                np.isclose(positions[:, 2], lz).nonzero()[0],
            )
        )

    # Charge source: the NonbondedForce, or a custom force exposing a
    # charge parameter index.
    if nbforce is None:
        charge_force = charge_index = None
        for force, params in cnbforces.items():
            if params and "charge" in params:
                charge_force, charge_index = force, params["charge"]
                break
        if charge_force is None:
            raise ValueError("No charge information provided.")
    else:
        charge_force, charge_index = nbforce, 0
    qs = _particle_charges(charge_force, charge_index)
    q_tot = qs.sum()
    electroneutral = np.isclose(q_tot, 0)

    # Collective variables for the correction energies.
    cv_e_corr = openmm.CustomExternalForce("q*(1-2*z/L)")
    cv_e_corr.addGlobalParameter("L", dims[2])
    cv_e_corr.addPerParticleParameter("q")
    cv_mz = openmm.CustomExternalForce("q*z")
    cv_mz.addPerParticleParameter("q")
    cv_mzz = openmm.CustomExternalForce("q*z^2")
    cv_mzz.addPerParticleParameter("q")
    for i, q in enumerate(qs):
        if not np.isclose(q, 0):
            cv_e_corr.addParticle(i, (q,))
            cv_mz.addParticle(i, (q,))
            cv_mzz.addParticle(i, (q,))

    # Expand the box along z to hold the image cells.
    dims[2] *= n_cells
    topology.setUnitCellDimensions(dims)
    pbv[2] *= n_cells
    system.setDefaultPeriodicBoxVectors(*pbv)
    logging.info(f"Increased z-dimension to {dims[2]}.")

    # Higher-order corrections (beta vanishes analytically for
    # gamma = +-1) and net-charge terms.
    beta = (_ic_beta(gamma, 0) + _ic_beta(gamma, 0.5)) / 2
    corr_energy = ""
    corr = openmm.CustomCVForce("0")
    if not np.isclose(beta, 0):
        corr_energy += "coef1*E_corr*M_z"
        corr.addCollectiveVariable("E_corr", cv_e_corr)
        corr.addGlobalParameter(
            "coef1",
            (
                unit.AVOGADRO_CONSTANT_NA
                * gamma
                * beta
                / (4 * np.pi * VACUUM_PERMITTIVITY * dims[2] ** 2)
            ).in_units_of(
                unit.kilojoule_per_mole
                / (unit.elementary_charge**2 * unit.nanometer)
            ),
        )
    if not np.isclose(gamma, -1):
        corr_energy += "+coef2*M_z^2"
    if not electroneutral:
        if np.isclose(gamma, 1):
            corr_energy += "-coef2*q_tot*M_z*L_z"
        elif np.isclose(gamma, -1):
            corr_energy += "+coef2*q_tot*(M_z*L_z-M_zz)"
        else:
            corr_energy += "-coef2*q_tot*M_zz"
        corr.addGlobalParameter("q_tot", q_tot)
    if "coef2" in corr_energy:
        corr.addGlobalParameter(
            "coef2",
            (
                unit.AVOGADRO_CONSTANT_NA
                / (
                    2
                    * VACUUM_PERMITTIVITY
                    * dims[0]
                    * dims[1]
                    * dims[2]
                )
            ).in_units_of(
                unit.kilojoule_per_mole
                / (unit.elementary_charge * unit.nanometer) ** 2
            ),
        )
    if "L_z" in corr_energy:
        corr.addGlobalParameter("L_z", dims[2])
    if "M_z" in corr_energy:
        corr.addCollectiveVariable("M_z", cv_mz)
    if "M_zz" in corr_energy:
        corr.addCollectiveVariable("M_zz", cv_mzz)
    if corr_energy:
        corr.setEnergyFunction(corr_energy.lstrip("+"))
        system.addForce(corr)
        logging.info(
            "Added higher-order image charge and/or slab "
            "correction(s)."
        )

    # Mirror positions into the image cells.
    if n_cells == 2:
        positions = (
            np.concatenate(
                (positions, positions * np.array((1, 1, -1)))
            )
            * unit.nanometer
        )
    else:
        # Tile by the ORIGINAL cell height, as the JAX package does.
        # MDHelper offsets by the already-scaled box (its
        # ``system.py:794-795``: ``dims[2] *= n_cells`` happens first),
        # which puts cell 2 at -2*n_cells*L_z = 0 (mod n_cells*L_z), on
        # top of the real cell.
        lz = dims[2].value_in_unit(unit.nanometer) / n_cells
        positions = np.tile(positions, (n_cells, 1))
        for cell in range(1, n_cells):
            lo, hi = cell * n_real, (cell + 1) * n_real
            positions[lo:hi, 2] = (
                (1 - 2 * (cell % 2)) * positions[lo:hi, 2]
                - 2 * np.floor(cell / 2) * lz
            )
        positions = positions * unit.nanometer
    logging.info(
        f"Replicated {n_real:,} particles {n_cells - 1} time(s) over "
        "the z-axis."
    )

    integrator = ICLangevinIntegrator(temp, fric, dt, n_cells)

    # Register the image particles in the topology and the forces.
    n_real_chains = topology.getNumChains()
    atoms = list(topology.atoms())
    residues = list(topology.residues())
    cell_coefs = (1, gamma)
    for cell in range(1, n_cells):
        coef = cell_coefs[cell % 2]
        chains_ic = [
            topology.addChain() for _ in range(n_real_chains)
        ]
        residues_ic = [
            topology.addResidue(
                f"IC_{r.name}", chains_ic[r.chain.index]
            )
            for r in residues
        ]
        for i, atom in enumerate(atoms):
            system.addParticle(0)
            topology.addAtom(
                f"IC_{atom.name}",
                atom.element,
                residues_ic[atom.residue.index],
            )
            if nbforce is not None:
                nbforce.addParticle(
                    0
                    if i in wall_indices
                    else coef * nbforce.getParticleParameters(i)[0],
                    0,
                    0,
                )
            for force, kwargs in cnbforces.items():
                params = np.array(force.getParticleParameters(i))
                if kwargs is None:
                    params[:] = 0
                else:
                    if "charge" in kwargs:
                        params[kwargs["charge"]] *= (
                            0 if i in wall_indices else coef
                        )
                    if "zero" in kwargs:
                        params[kwargs["zero"]] = 0
                    if "replace" in kwargs:
                        for index, value in kwargs["replace"].items():
                            params[index] = (
                                value[params[index]]
                                if isinstance(value, dict)
                                else value
                            )
                force.addParticle(params)
    logging.info(
        f"Registered {system.getNumParticles() - n_real:,} image "
        "particles to the force field."
    )

    # Mirror the existing exclusions into each image cell.
    for i in range(nbforce.getNumExceptions()):
        i1, i2, qq = nbforce.getExceptionParameters(i)[:3]
        if i1 not in wall_indices and i2 not in wall_indices:
            for cell in range(1, n_cells):
                nbforce.addException(
                    cell * n_real + i1, cell * n_real + i2, qq, 0, 0
                )
                for force in cnbforces:
                    j1, j2 = force.getExclusionParticles(i)
                    force.addExclusion(
                        cell * n_real + j1, cell * n_real + j2
                    )
    logging.info(
        "Mirrored excluded non-wall image particle-image particle "
        "interactions."
    )

    # Remove (wall, image-wall) self interactions.
    if exclude:
        for i in wall_indices:
            for j in wall_indices:
                for cell in range(1, n_cells):
                    nbforce.addException(
                        i, cell * n_real + j, 0, 0, 0
                    )
                    for force in cnbforces:
                        force.addExclusion(i, cell * n_real + j)
    else:
        for i in wall_indices:
            for cell in range(1, n_cells):
                nbforce.addException(i, cell * n_real + i, 0, 0, 0)
                for force in cnbforces:
                    force.addExclusion(i, cell * n_real + i)
    logging.info("Removed wall-image wall interactions.")

    return positions, integrator


def add_electric_field(
    system: openmm.System,
    nbforce,
    E,
    *,
    axis: int = 2,
    dielectric: float = 1,
    charge_index: int = 0,
    atom_indices=None,
) -> None:
    r"""Apply a uniform electric field along `axis`:
    :math:`U = -qEz` per charged particle.
    """

    _require_openmm()

    z = chr(120 + axis)
    if atom_indices is None:
        atom_indices = range(nbforce.getNumParticles())
    elif isinstance(atom_indices, int):
        atom_indices = range(atom_indices)

    efield = openmm.CustomExternalForce(f"-q*E*{z}")
    efield.addGlobalParameter("E", E)
    efield.addPerParticleParameter("q")
    for i in atom_indices:
        q = nbforce.getParticleParameters(i)[charge_index]
        if isinstance(q, unit.Quantity):
            q = q.value_in_unit(unit.elementary_charge)
        if not np.isclose(q, 0):
            efield.addParticle(i, (q * np.sqrt(dielectric),))
    system.addForce(efield)


def estimate_pressure_tensor(
    context: openmm.Context, dh: float = 1e-5, *, diag: bool = False
) -> np.ndarray:
    r"""Estimate the pressure tensor by central finite differences of
    the potential energy with respect to box deformations:

    .. math::

       p_{ij} = \frac{1}{V}\left(\sum_k m_k v_{k,i} v_{k,j}
       - \frac{\partial U}{\partial h_{ij}}\right)

    With ``diag=True`` only the diagonal is evaluated.
    """

    _require_openmm()

    try:
        state = context.getState(
            getPositions=True, getVelocities=True, getEnergy=True
        )
        box = state.getPeriodicBoxVectors(asNumpy=True)
        positions = state.getPositions(asNumpy=True)
        velocities = state.getVelocities(asNumpy=True)
        volume = box[0, 0] * box[1, 1] * box[2, 2]
    except openmm.OpenMMException:
        raise ValueError(
            "The simulation context must have information about the "
            "particle positions and velocities."
        )
    system = context.getSystem()
    masses = (
        np.fromiter(
            (
                system.getParticleMass(i).value_in_unit(unit.dalton)
                for i in range(system.getNumParticles())
            ),
            dtype=float,
        )
        * unit.dalton
    )

    def perturbed_energy(i, j, sign):
        box_ = box.copy()
        box_[i, j] += sign * dh
        context.setPeriodicBoxVectors(*box_)
        context.setPositions(
            np.dot(
                positions,
                np.divide(
                    box_,
                    box,
                    out=np.zeros_like(box),
                    where=box.value_in_unit(unit.nanometer) != 0,
                ),
            )
        )
        return context.getState(getEnergy=True).getPotentialEnergy()

    if diag:
        p_kinetic = (masses * velocities**2).sum(axis=0)
        p_virial = np.zeros(3) * unit.kilojoule_per_mole
        for i in range(3):
            p_virial[i] = perturbed_energy(i, i, 1) - perturbed_energy(
                i, i, -1
            )
        p_virial = (p_virial / (2 * dh)).in_units_of(p_kinetic.unit)
    else:
        p_kinetic = (
            masses * velocities * velocities[:, :, None]
        ).sum(axis=0)
        p_virial = np.zeros((3, 3)) * unit.kilojoule_per_mole
        for i in range(3):
            for j in range(i + 1):
                p_virial[i, j] = perturbed_energy(
                    i, j, 1
                ) - perturbed_energy(i, j, -1)
        p_virial = (p_virial / (2 * dh)).in_units_of(p_kinetic.unit)
        p_virial = (
            p_virial._value
            + np.tril(p_virial).T
            - np.diag(np.diag(p_virial))
        ) * p_virial.unit

    return (
        (p_kinetic + p_virial) / (unit.AVOGADRO_CONSTANT_NA * volume)
    ).in_units_of(unit.atmosphere)
