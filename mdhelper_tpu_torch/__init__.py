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
:class:`~mdhelper_tpu_torch.analysis.transport.Onsager`), the cross RDF
of two disjoint groups, and
:class:`~mdhelper_tpu_torch.analysis.structure.VanHoveFunction`.
"""

from ._device import set_precision_policy

set_precision_policy()

VERSION = "1.0.0"
__version__ = VERSION

__all__ = ["VERSION"]
