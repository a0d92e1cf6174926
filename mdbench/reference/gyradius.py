"""Radius of gyration of unwrapped linear chains of equal-mass monomers,
``sqrt(mean_n |r_n - r_com|^2)`` a chain, averaged over the chains, a
frame (``Gyradius(unwrap=True)``'s ``results.gyradii``)."""

import numpy as np
import torch

from mdbench.reference._chains import unwrapped_chains
from mdbench.reference._common import relative_gap


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    chains = unwrapped_chains(frames, dimensions, spec, device, dtype)
    dr = chains - chains.mean(dim=2, keepdim=True)
    rg = torch.sqrt((dr * dr).sum(dim=-1).mean(dim=-1)).mean(dim=-1)
    return {"gyradii": rg.double().cpu().numpy()}


def judge(taken, want):
    return {"rg_gap": relative_gap(np.asarray(taken["gyradii"]).reshape(-1),
                                   want["gyradii"])}
