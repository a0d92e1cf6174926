"""
MDHelper-TPU, PyTorch and CUDA port
===================================

A second implementation of :mod:`mdhelper_tpu` on PyTorch, whose hot
kernels are written by hand in CUDA C++ for NVIDIA Hopper (``sm_90a``).
The module layout mirrors the JAX package so each counterpart is easy
to find; the JAX package stays the reference the port is tested
against, and this package never imports it (nor JAX).

The port currently covers the fused RDF + S(q) + MSD main path
(:func:`mdhelper_tpu_torch.analysis.multi.run_together` over
:class:`~mdhelper_tpu_torch.analysis.structure.RadialDistributionFunction`,
:class:`~mdhelper_tpu_torch.analysis.structure.StructureFactor` and
:class:`~mdhelper_tpu_torch.analysis.transport.Onsager`), the cross RDF,
:class:`~mdhelper_tpu_torch.analysis.structure.VanHoveFunction` and
:class:`~mdhelper_tpu_torch.analysis.structure.IntermediateScatteringFunction`,
the topology and center-of-mass groupings, the unit registry
(``ureg``, ``Q_``) with the post-hoc methods of these classes
(coordination numbers, potentials of mean force, transport coefficients
and conductivities, charge structure factors), the file layer
(:meth:`~mdhelper_tpu_torch.core.universe.Universe.from_files`, the
selection language, the trajectory readers and writers of
:mod:`mdhelper_tpu_torch.io`), and the density profiles and
electrostatics (:mod:`mdhelper_tpu_torch.analysis.profile`:
:class:`~mdhelper_tpu_torch.analysis.profile.DensityProfile` and the
Poisson potential, the radial profile and the 2-D and 3-D density maps;
:mod:`mdhelper_tpu_torch.analysis.electrostatics`: dipole moments, the
relative permittivity and the dielectric spectrum) on the serial
:class:`~mdhelper_tpu_torch.analysis.base.DynamicAnalysisBase`, and the
polymer analyses and thermodynamics
(:mod:`mdhelper_tpu_torch.analysis.polymer`: radii of gyration and shape,
end-to-end vectors, Rouse modes, the single-chain structure factor on the
trig-sums kernel, persistence lengths, internal distances;
:mod:`mdhelper_tpu_torch.analysis.thermodynamics`: heat capacities from
LAMMPS and OpenMM logs, Green-Kubo and Einstein-Helfand coefficients).
:mod:`mdhelper_tpu_torch.parallel` runs analyses over the ranks of
:mod:`torch.distributed`, one a device: frame-sharded runs, the
atom-sharded RDF ring and the q-sharded S(q).
"""

from importlib.util import find_spec

from ._device import set_precision_policy
from .units import Quantity, UnitRegistry

set_precision_policy()

#: The quantity type and the global registry, as in the JAX package: the
#: port's own numpy-only unit engine (:mod:`mdhelper_tpu_torch.units`).
Q_ = Quantity
ureg = UnitRegistry(auto_reduce_dimensions=True)

VERSION = "1.0.0"
__version__ = VERSION
FOUND_OPENMM = find_spec("openmm") is not None

__all__ = ["FOUND_OPENMM", "VERSION", "Q_", "ureg"]
