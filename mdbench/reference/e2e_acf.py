"""Autocorrelation of the chains' unit end-to-end vectors, ``<u(t) .
u(t + m)>`` over origins and chains (``EndToEndVector(unwrap=True)``'s
``results.acf``)."""

import numpy as np
import torch

from mdbench.reference._chains import autocorrelation, unwrapped_chains
from mdbench.reference._common import relative_gap


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    chains = unwrapped_chains(frames, dimensions, spec, device, dtype)
    ends = chains[:, :, -1] - chains[:, :, 0]
    unit = ends / torch.linalg.vector_norm(ends, dim=-1, keepdim=True)
    return {"acf": autocorrelation(unit)}


def judge(taken, want):
    return {"e2e_acf_gap": relative_gap(np.asarray(taken["acf"]).reshape(-1),
                                        want["acf"])}
