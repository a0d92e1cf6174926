"""The signatures of the port's public classes and functions against their
JAX counterparts: every parameter of the JAX signature is in the port's,
with the same kind and default, or on the explicit list of parameters not
ported yet below; every parameter the port adds is listed as the port's
own.  Both lists must stay exact: an entry that the port has since gained,
or lost, fails the test.
"""

import importlib
import inspect

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

#: JAX parameters the port does not take, by object, with the reason: the
#: JAX parallel runner's worker-pool options, which the ranks replace and no
#: slice brings (parallel/, ROADMAP Queue 1 item 10).
NOT_PORTED = {
    "analysis.base.ParallelAnalysisBase.run": {
        "block": "parallel/ (item 10): the JAX worker pool's option, not "
                 "taken (the ranks are the workers)",
        "method": "parallel/ (item 10): the JAX worker pool's option, not "
                  "taken (the ranks are the workers)",
    },
}

#: Parameters the port takes whose other values are not ported yet: none.
#: Every class on ``DynamicAnalysisBase`` takes ``parallel=True``
#: (``TICA`` on one rank, as the JAX package runs it unsharded).
NOT_PORTED_VALUES = {}

#: The classes that took ``parallel=True`` last, with parallel/'s second
#: part (ROADMAP Queue 1 item 10b-2); each also takes the JAX classes'
#: ``**kwargs``.
LAST_PARALLEL = (
    "analysis.cluster.ClusterSizeDistribution",
    "analysis.hbonds.HydrogenBondAnalysis",
    "analysis.orientation.NematicOrderParameter",
    "analysis.orientation.OrientationProfile",
    "analysis.steinhardt.SteinhardtOrderParameter",
    "analysis.steinhardt.TetrahedralOrderParameter",
    "analysis.interface.WillardChandlerInterface",
    "analysis.interface.IntrinsicDensityProfile",
    "analysis.rmsd.RMSD",
    "analysis.rmsd.RMSF",
    "analysis.rmsd.PrincipalComponentAnalysis",
    "analysis.rmsd.TICA",
    "analysis.bonded.BondLengthDistribution",
    "analysis.bonded.BondAngleDistribution",
    "analysis.bonded.DihedralDistribution",
    "analysis.contacts.NativeContacts",
    "analysis.pairing.IonPairAnalysis",
    "analysis.sasa.SolventAccessibleSurfaceArea",
)

#: Parameters of the port's own: the device of an analysis (and of the
#: radial histogram, of the ring, of the FFTs of the transport functions
#: and of the lifetimes' correlation), the JAX ISF's ``shard`` and
#: ``method`` (which it takes through ``**kwargs``), the carry of a run
#: that the JAX package began, and the ranks (``mesh``) and tile axis of
#: the frame blocks and the gather, which JAX reads from its global
#: arrays.
PORT_ONLY = {
    "parallel.mesh.process_frame_block": {"mesh"},
    "parallel.mesh.fetch_global": {"mesh", "axis"},
    "parallel.ring.ring_radial_histogram": {"device"},
    "analysis.base.ParallelAnalysisBase": {"device"},
    "analysis.structure.radial_histogram": {"device"},
    "analysis.structure.RadialDistributionFunction": {"device"},
    "analysis.structure.StructureFactor": {"device"},
    "analysis.structure.IntermediateScatteringFunction": {
        "device", "shard", "method"},
    "analysis.structure.VanHoveFunction": {"device"},
    "analysis.transport.Onsager": {"device"},
    "analysis.multi.run_together": {"initial"},
    "analysis.base.DynamicAnalysisBase": {"device"},
    "analysis.profile.DensityProfile": {"device"},
    "analysis.profile.RadialDensityProfile": {"device"},
    "analysis.profile.DensityMap2D": {"device"},
    "analysis.profile.DensityMap3D": {"device"},
    "analysis.electrostatics.DipoleMoment": {"device"},
    "analysis.polymer.Gyradius": {"device"},
    "analysis.polymer.EndToEndVector": {"device"},
    "analysis.polymer.SingleChainStructureFactor": {"device"},
    "analysis.polymer.RouseModes": {"device"},
    "analysis.polymer.PersistenceLength": {"device"},
    "analysis.polymer.MeanSquareInternalDistance": {"device"},
    "analysis.cluster.ClusterSizeDistribution": {"device"},
    "analysis.hbonds.HydrogenBondAnalysis": {"device"},
    "analysis.orientation.NematicOrderParameter": {"device"},
    "analysis.orientation.OrientationProfile": {"device"},
    "analysis.steinhardt.SteinhardtOrderParameter": {"device"},
    "analysis.steinhardt.TetrahedralOrderParameter": {"device"},
    "analysis.base.existence_lifetimes": {"device"},
    "analysis.electrostatics.calculate_dielectric_spectrum": {"device"},
    "analysis.thermodynamics.calculate_shear_viscosity": {"device"},
    "analysis.thermodynamics.calculate_thermal_conductivity": {"device"},
    "analysis.thermodynamics.calculate_ionic_conductivity": {"device"},
    "analysis.dynamics.VelocityAutocorrelation": {"device"},
    "analysis.dynamics.ElectricCurrentAutocorrelation": {"device"},
    "analysis.dynamics.SurvivalProbability": {"device"},
    "analysis.dynamics.OverlapFunction": {"device"},
    "analysis.flow.FlowProfile": {"device"},
    "analysis.interface.WillardChandlerInterface": {"device"},
    "analysis.interface.IntrinsicDensityProfile": {"device"},
    "analysis.rmsd.RMSD": {"device"},
    "analysis.rmsd.RMSF": {"device"},
    "analysis.rmsd.PrincipalComponentAnalysis": {"device"},
    "analysis.bonded.BondLengthDistribution": {"device"},
    "analysis.bonded.BondAngleDistribution": {"device"},
    "analysis.bonded.DihedralDistribution": {"device"},
    "analysis.contacts.NativeContacts": {"device"},
    "analysis.pairing.IonPairAnalysis": {"device"},
    "analysis.sasa.SolventAccessibleSurfaceArea": {"device"},
}

OBJECTS = [
    "analysis.structure.RadialDistributionFunction",
    "analysis.structure.StructureFactor",
    "analysis.structure.IntermediateScatteringFunction",
    "analysis.structure.IntermediateScatteringFunction."
    "calculate_dynamic_structure_factor",
    "analysis.structure.VanHoveFunction",
    "analysis.transport.Onsager",
    "analysis.multi.run_together",
    "analysis.structure.radial_histogram",
    "analysis.structure.zeroth_order_hankel_transform",
    "analysis.structure.radial_fourier_transform",
    "analysis.structure.calculate_coordination_numbers",
    "analysis.structure.calculate_structure_factor",
    "analysis.structure.RadialDistributionFunction."
    "calculate_coordination_numbers",
    "analysis.structure.RadialDistributionFunction.calculate_pmf",
    "analysis.structure.RadialDistributionFunction."
    "calculate_structure_factor",
    "analysis.structure.StructureFactor.calculate_weighted_sum",
    "analysis.structure.StructureFactor.calculate_charge_structure_factor",
    "analysis.structure.StructureFactor.calculate_screening_length",
    "analysis.transport.msd_fft",
    "analysis.transport.msd_shift",
    "analysis.transport.calculate_transport_coefficients",
    "analysis.transport.calculate_conductivity",
    "analysis.transport.calculate_nernst_einstein_conductivity",
    "analysis.transport.calculate_electrophoretic_mobility",
    "analysis.transport.calculate_transference_number",
    "analysis.transport.Onsager.calculate_transport_coefficients",
    "analysis.transport.Onsager.calculate_conductivity",
    "analysis.transport.Onsager.calculate_nernst_einstein_conductivity",
    "analysis.transport.Onsager.calculate_ionicity",
    "analysis.transport.Onsager.calculate_electrophoretic_mobility",
    "analysis.transport.Onsager.calculate_transference_number",
    "algorithm.unit.strip_unit",
    "algorithm.unit.get_scaling_factors",
    "algorithm.unit.get_lj_scaling_factors",
    "algorithm.correlation.msd_shift",
    "algorithm.correlation.correlation_shift",
    "core.universe.Topology",
    "core.universe.Universe",
    "core.universe.Universe.from_arrays",
    "core.trajectory.ArrayReader",
    "algorithm.topology.unwrap_edge",
    "algorithm.topology.minimize_vectors",
    "algorithm.topology.wrap",
    "algorithm.topology.triclinic_vectors",
    "algorithm.topology.triclinic_matrices",
    "algorithm.utility.get_closest_factors",
    "algorithm.utility.depth_first_search",
    "algorithm.utility.find_connected_nodes",
    "algorithm.correlation.msd_fft",
    "algorithm.correlation.correlation_fft",
    "ops.pbc.unwrap_scan",
    "ops.pbc.wrap_positions",
    # files: readers, writers, parsers, the universe's file entry points
    "core.universe.Universe.from_files",
    "core.universe.Universe.guess_bonds",
    "core.universe.Universe.select_atoms",
    "core.universe.AtomGroup.select_atoms",
    "core.universe.AtomGroup.write",
    "core.trajectory.open_trajectory",
    "core.trajectory.NPZReader",
    "core.trajectory.NetCDFReader",
    "core.trajectory.DCDReader",
    "core.trajectory.XTCReader",
    "core.trajectory.TRRReader",
    "core.trajectory.LAMMPSDumpReader",
    "core.trajectory.XYZReader",
    "core.trajectory.GROReader",
    "core.trajectory.PDBReader",
    "core.trajectory.TrajectoryReader.read_velocity_frames",
    "core.trajectory.TrajectoryReader.read_frames_with_velocities",
    "core.trajectory.TrajectoryReader.read_dimension_frames",
    "core.trajectory.TrajectoryReader.read_force_frames",
    "io.open_trajectory_writer",
    "io.dcd.DCDFile",
    "io.dcd.DCDWriter",
    "io.dcd.write_dcd",
    "io.xtc.XTCFile",
    "io.xtc.XTCWriter",
    "io.xtc.write_xtc",
    "io.xtc.compress_coords",
    "io.xtc.decompress_coords",
    "io.trr.TRRFile",
    "io.trr.TRRWriter",
    "io.trr.write_trr",
    "io.lammps_dump.LAMMPSDumpFile",
    "io.lammps_dump.LAMMPSDumpWriter",
    "io.lammps_dump.write_lammps_dump",
    "io.netcdf3.Dataset",
    "io.structure_writers.write_pdb",
    "io.structure_writers.write_gro",
    "io.structure_writers.write_xyz",
    "io.topology_files.read_topology_file",
    "io.topology_files.read_psf",
    "io.topology_files.read_pdb",
    "io.topology_files.read_gro",
    "io.topology_files.read_lammps_data",
    "io.topology_files.read_gmx_top",
    "io.topology_files.read_prmtop",
    "io.tpr.read_tpr",
    "algorithm.topology.guess_bonds",
    "algorithm.topology.resolve_vdw_radii",
    # density profiles and electrostatics
    "analysis.base.DynamicAnalysisBase",
    "analysis.profile.calculate_potential_profile",
    "analysis.profile.DensityProfile",
    "analysis.profile.DensityProfile.calculate_potential_profile",
    "analysis.profile.DensityProfile.calculate_pmf",
    "analysis.profile.RadialDensityProfile",
    "analysis.profile.RadialDensityProfile.calculate_pmf",
    "analysis.profile.DensityMap2D",
    "analysis.profile.DensityMap3D",
    "analysis.electrostatics.calculate_relative_permittivity",
    "analysis.electrostatics.calculate_dielectric_spectrum",
    "analysis.electrostatics.DipoleMoment",
    "analysis.electrostatics.DipoleMoment.calculate_relative_permittivity",
    "ops.profiles.axis_histogram_batch",
    "ops.profiles.plane_histogram_batch",
    "ops.profiles.volume_histogram_batch",
    # polymer analyses and thermodynamics
    "analysis.polymer.calculate_relaxation_time",
    "analysis.polymer.Gyradius",
    "analysis.polymer.EndToEndVector",
    "analysis.polymer.EndToEndVector.calculate_relaxation_time",
    "analysis.polymer.SingleChainStructureFactor",
    "analysis.polymer.SingleChainStructureFactor.calculate_guinier_radius",
    "analysis.polymer.RouseModes",
    "analysis.polymer.RouseModes.calculate_relaxation_time",
    "analysis.polymer.PersistenceLength",
    "analysis.polymer.PersistenceLength.calculate_persistence_length",
    "analysis.polymer.MeanSquareInternalDistance",
    "analysis.thermodynamics.ConstantVolumeHeatCapacity",
    "analysis.thermodynamics.ConstantVolumeHeatCapacity.run",
    "analysis.thermodynamics.calculate_shear_viscosity",
    "analysis.thermodynamics.calculate_thermal_conductivity",
    "analysis.thermodynamics.calculate_ionic_conductivity",
    "fit.exponential.exp",
    "fit.exponential.exp1",
    "fit.exponential.exp2",
    "fit.exponential.biexp",
    "fit.exponential.stretched_exp",
    # the mesh S(q) route, aggregates and order
    "ops.mesh_scattering.mesh_plan",
    "analysis.base.existence_lifetimes",
    "analysis.base.DynamicAnalysisBase._uniform_lag_dt",
    "analysis.cluster.ClusterSizeDistribution",
    "analysis.hbonds.HydrogenBondAnalysis",
    "analysis.orientation.NematicOrderParameter",
    "analysis.orientation.OrientationProfile",
    "analysis.steinhardt.SteinhardtOrderParameter",
    "analysis.steinhardt.TetrahedralOrderParameter",
    "algorithm.spherical.sph_harm_columns",
    "algorithm.spherical.complex_from_real",
    "algorithm.spherical.invariant_ql",
    "algorithm.spherical.invariant_wl",
    "algorithm.spherical.wigner_3j",
    "algorithm.spherical.wigner_3j_lll",
    # the velocity stream, survival and overlap, flow, interfaces and
    # free energy
    "analysis.dynamics.VelocityAutocorrelation",
    "analysis.dynamics.ElectricCurrentAutocorrelation",
    "analysis.dynamics.SurvivalProbability",
    "analysis.dynamics.OverlapFunction",
    "analysis.flow.FlowProfile",
    "analysis.interface.WillardChandlerInterface",
    "analysis.interface.IntrinsicDensityProfile",
    "analysis.flow.FlowProfile.calculate_shear_rate",
    "analysis.interface.coarse_grained_heights",
    "analysis.interface.interpolate_height_maps",
    "analysis.interface.slab_interface_heights",
    "analysis.interface.WillardChandlerInterface.calculate_spectrum",
    "analysis.interface.WillardChandlerInterface.calculate_surface_tension",
    "analysis.interface.IntrinsicDensityProfile.calculate_pmf",
    "analysis.free_energy.harmonic_bin_bias",
    "analysis.free_energy.fep",
    "analysis.free_energy.bar",
    "analysis.free_energy.mbar",
    "analysis.free_energy.wham",
    "analysis.free_energy.UmbrellaSampling",
    "analysis.free_energy.UmbrellaSampling.run",
    "ops.profiles.grid_deposit_frames",
    "ops.profiles.gaussian_smooth_periodic",
    "algorithm.topology.box_volume",
    # molecules: superposition, bonded distributions, native contacts, and
    # the molecule, accelerated, unwrap, pbc and utility functions
    "analysis.rmsd.RMSD",
    "analysis.rmsd.RMSF",
    "analysis.rmsd.PrincipalComponentAnalysis",
    "analysis.rmsd.PrincipalComponentAnalysis.transform",
    "analysis.rmsd.TICA",
    "analysis.rmsd.TICA.transform",
    "analysis.bonded.derive_angles",
    "analysis.bonded.derive_dihedrals",
    "analysis.bonded.BondLengthDistribution",
    "analysis.bonded.BondAngleDistribution",
    "analysis.bonded.DihedralDistribution",
    "analysis.contacts.NativeContacts",
    "algorithm.molecule.center_of_mass",
    "algorithm.molecule.radius_of_gyration",
    "algorithm.topology.unwrap",
    "algorithm.utility.replicate",
    "algorithm.utility.rebin",
    "ops.pbc.min_image_displacement",
    "ops.pbc.com_shift_scan",
    "algorithm.accelerated.dot_1d_1d",
    "algorithm.accelerated.delta_fourier_transform_1d_1d",
    "algorithm.accelerated.delta_fourier_transform_sum_2d_2d",
    "algorithm.accelerated.delta_fourier_transform_sum_parallel_2d_2d",
    "algorithm.accelerated.inner_2d_2d",
    "algorithm.accelerated.inner_parallel_2d_2d",
    "algorithm.accelerated.pythagorean_trigonometric_identity_1d",
    "algorithm.accelerated.pythagorean_trigonometric_identity_1d_1d",
    "algorithm.accelerated.cosine_sum_1d",
    "algorithm.accelerated.cosine_sum_2d",
    "algorithm.accelerated.cosine_sum_parallel_2d",
    "algorithm.accelerated.cosine_sum_inplace_2d",
    "algorithm.accelerated.cosine_sum_inplace_parallel_2d",
    "algorithm.accelerated.sine_sum_1d",
    "algorithm.accelerated.sine_sum_2d",
    "algorithm.accelerated.sine_sum_parallel_2d",
    "algorithm.accelerated.sine_sum_inplace_2d",
    "algorithm.accelerated.sine_sum_inplace_parallel_2d",
    # checkpoints, ion pairing and SASA
    "core.checkpoint.save_carry",
    "core.checkpoint.load_carry",
    "analysis.base.SerialAnalysisBase.run",
    "analysis.pairing.IonPairAnalysis",
    "analysis.sasa.sphere_points",
    "analysis.sasa.SolventAccessibleSurfaceArea",
    "analysis.sasa.SolventAccessibleSurfaceArea.run",
    # parallel/ on torch.distributed: the ranks, the ring, the runners
    "parallel.mesh.initialize_distributed",
    "parallel.mesh.get_mesh",
    "parallel.mesh.process_frame_block",
    "parallel.mesh.fetch_global",
    "parallel.ring.ring_radial_histogram",
    "analysis.base.ParallelAnalysisBase",
    "analysis.base.ParallelAnalysisBase.run",
    "analysis.base.DynamicAnalysisBase.run",
    # the host-only packages: the n_threads shim, create_atoms, profiling,
    # fit, lammps, plot and the OpenMM modules that import without OpenMM
    # (tests/test_torch_openmm.py holds the others' signatures under a fake
    # OpenMM)
    "analysis.base.NumbaAnalysisBase.run",
    "algorithm.topology.create_atoms",
    "core.profiling.Timer",
    "core.profiling.Timer.report",
    "core.profiling.trace",
    "core.profiling.benchmark_grid",
    "fit.distribution.weibull",
    "fit.fourier.fourier",
    "fit.fourier.fourier1",
    "fit.fourier.fourier8",
    "fit.gaussian.gauss",
    "fit.gaussian.gauss1",
    "fit.gaussian.gauss8",
    "fit.polynomial.poly",
    "fit.polynomial.poly1",
    "fit.polynomial.poly9",
    "fit.power.power",
    "fit.power.power1",
    "fit.power.power2",
    "lammps.topology.create_atoms",
    "lammps.topology.write_data",
    "plot.axis.set_up_tabular_legend",
    "plot.color.adjust_lightness",
    "plot.rcparam.update",
    "openmm.expressions.ewald_g",
    "openmm.expressions.pme_mesh_dimensions",
    "openmm.expressions.coul_gauss_energy",
    "openmm.expressions.dpd_energy",
    "openmm.expressions.gauss_energy",
    "openmm.expressions.ljts_energy",
    "openmm.expressions.solvation_energy",
    "openmm.expressions.yukawa_energy",
    "openmm.expressions.fene_energy",
    "openmm.file.NetCDFFile",
    "openmm.file.NetCDFFile.get_dimensions",
    "openmm.file.NetCDFFile.get_times",
    "openmm.file.NetCDFFile.get_positions",
    "openmm.file.NetCDFFile.get_velocities",
    "openmm.file.NetCDFFile.get_forces",
    "openmm.file.NetCDFFile.write_header",
    "openmm.file.NetCDFFile.write_file",
    "openmm.file.NetCDFFile.write_model",
    "openmm.unit.get_scaling_factors",
    "openmm.unit.get_lj_scaling_factors",
    "openmm.system.register_particles",
    "openmm.system.add_slab_correction",
    "openmm.system.add_image_charges",
    "openmm.system.add_electric_field",
    "openmm.system.estimate_pressure_tensor",
    "openmm.utility.optimize_pme",
]


#: JAX objects the port does not have, with the reason: the JAX mesh's
#: placements and its chunk padding, which the ranks do not need (each
#: reads its block of the chunk the stream pads).
NOT_PORTED_OBJECTS = {
    "parallel.mesh.frame_sharding": "a chunk's placement on the JAX mesh",
    "parallel.mesh.replicated_sharding": "a carry's placement on the JAX "
                                         "mesh",
    "parallel.mesh.pad_to_multiple": "the JAX stream's chunk padding; the "
                                     "port's stream pads its chunks itself",
}


def _resolve(package, dotted):
    """The object at `dotted` (module path, then attribute path) in
    `package`."""

    parts = dotted.split(".")
    for split in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(
                ".".join([package, *parts[:split]]))
        except ModuleNotFoundError:
            continue
        for attr in parts[split:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


@pytest.mark.parametrize("dotted", OBJECTS)
def test_signature_matches_jax(dotted):
    ref = inspect.signature(_resolve("mdhelper_tpu", dotted)).parameters
    port = inspect.signature(_resolve("mdhelper_tpu_torch", dotted)).parameters
    missing = {name for name in ref if name not in port}
    extra = {name for name in port if name not in ref}
    assert missing == set(NOT_PORTED.get(dotted, {}))
    assert extra == PORT_ONLY.get(dotted, set())
    for name in set(ref) & set(port):
        assert (port[name].kind, port[name].default) == (
            ref[name].kind, ref[name].default), name


@pytest.mark.parametrize("dotted", list(NOT_PORTED_OBJECTS))
def test_objects_not_ported_are_absent(dotted):
    """Each listed JAX object exists, and the port has no such name."""

    assert callable(_resolve("mdhelper_tpu", dotted))
    module, name = dotted.rsplit(".", 1)
    port = importlib.import_module(f"mdhelper_tpu_torch.{module}")
    assert not hasattr(port, name)
    assert name not in port.__all__


def test_groupings_are_ported_everywhere():
    listed = set().union(*(set(v) for v in NOT_PORTED.values()))
    assert not {"groupings", "grouping"} & listed
    for dotted in NOT_PORTED:
        assert dotted in OBJECTS


def test_units_centering_and_charges_are_ported():
    """Only the JAX worker pool's options remain: no checkpoint, unit,
    reduced-unit, centering, charge, file or mesh parameter, and no value
    that raises."""

    listed = set().union(*(set(v) for v in NOT_PORTED.values()))
    assert listed == {"block", "method"}
    assert not NOT_PORTED_VALUES
    for reasons in NOT_PORTED.values():
        for reason in reasons.values():
            assert "(item 10)" in reason, reason


def _universe():
    import numpy as np

    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(0)
    frames = (rng.random((2, 12, 3)) * 6.0).astype(np.float32)
    velocities = rng.standard_normal((2, 12, 3)).astype(np.float32)
    return Universe.from_arrays(frames, [6.0] * 3 + [90.0] * 3,
                                velocities=velocities,
                                charges=np.tile([1.0, -1.0], 6))


def _arguments(dotted, u):
    """``(args, kwargs)`` that construct the class at `dotted` on `u`."""

    if dotted.endswith("RadialDensityProfile"):
        return (u.atoms, u.atoms[:3]), {}
    if dotted.endswith("HydrogenBondAnalysis"):
        return (u,), dict(acceptors_sel="all",
                          donor_hydrogen_pairs=[[0, 1], [3, 4]])
    if dotted.endswith(("NematicOrderParameter", "OrientationProfile")):
        return (u.atoms[0::2], u.atoms[1::2]), {}
    if dotted.endswith(("ClusterSizeDistribution",
                        "SteinhardtOrderParameter")):
        return (u.atoms, 2.0), {}
    if dotted.endswith("ElectricCurrentAutocorrelation"):
        return (u.atoms, 300.0), {}
    if dotted.endswith("SurvivalProbability"):
        return (u.atoms, ("slab", "z", 1.0, 4.0)), {}
    if dotted.endswith("BondLengthDistribution"):
        return (u.atoms,), dict(bonds=[[0, 1], [1, 2]])
    if dotted.endswith("BondAngleDistribution"):
        return (u.atoms,), dict(angles=[[0, 1, 2]])
    if dotted.endswith("DihedralDistribution"):
        return (u.atoms,), dict(dihedrals=[[0, 1, 2, 3]])
    if dotted.endswith("TICA"):
        return (u.atoms,), dict(lag=1)
    if dotted.endswith("IonPairAnalysis"):
        return (u.atoms[0::2], u.atoms[1::2], 2.0), {}
    if dotted.endswith("SolventAccessibleSurfaceArea"):
        return (u.atoms,), dict(radii=[1.0] * 12, n_points=16)
    return (u.atoms,), {}


@pytest.mark.parametrize("dotted", LAST_PARALLEL)
def test_parallel_and_kwargs_are_taken(dotted, caplog):
    """``parallel=True`` runs (a world of one without a process group) to
    the default run's results, and a keyword of the JAX runtime is accepted
    and ignored with a debug line naming it."""

    import logging

    import numpy as np

    cls = _resolve("mdhelper_tpu_torch", dotted)
    u = _universe()
    args, kwargs = _arguments(dotted, u)
    with caplog.at_level(logging.DEBUG):
        sharded = cls(*args, device="cpu", verbose=False, parallel=True,
                      mesh_axis="frames", **kwargs)
    assert "mesh_axis" in caplog.text
    sharded.run()
    assert sharded._mesh.world == 1
    serial = cls(*args, device="cpu", verbose=False, **kwargs).run()
    for key, value in serial.results.items():
        if isinstance(value, np.ndarray) and value.dtype != object:
            np.testing.assert_array_equal(sharded.results[key], value,
                                          err_msg=key)
