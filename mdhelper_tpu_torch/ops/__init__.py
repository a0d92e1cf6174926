"""Tensor kernels: pair histograms, PBC transforms, structure-factor sums."""
