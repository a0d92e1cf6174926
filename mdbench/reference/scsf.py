"""Single-chain structure factor of unwrapped linear chains:
``S_sc(q) = < sum_chains |sum_n exp(i q . r_n)|^2 > / (M N_p)`` over the
frames, on the cubic box's grid ``q = 2 pi n / L`` (each component of n
in ``0 .. n_points - 1``, rounded to float32 as the analysis takes its
wavevectors), averaged over equal wavenumbers
(``SingleChainStructureFactor``'s ``results.scsf``)."""

import numpy as np
import torch

from mdbench.reference._chains import unwrapped_chains
from mdbench.reference._common import grouped_by_n2, relative_gap
from mdbench.reference.ssf import lattice_power


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    chains = unwrapped_chains(frames, dimensions, spec, device, dtype)
    n_points = int(spec["kwargs"]["n_points"])
    box = np.asarray(dimensions[:3], np.float64)
    power = torch.zeros((n_points,) * 3, dtype=dtype, device=device)
    for frame in chains:
        power += lattice_power(frame, box, n_points, dtype,
                               round_to_float32=True)
    n_frames, m, n_p = chains.shape[:3]
    n2, scsf = grouped_by_n2(power.double().cpu().numpy()
                             / (n_frames * m * n_p), n_points)
    return {"wavenumbers": 2 * np.pi * np.sqrt(n2) / box[0], "scsf": scsf}


def judge(taken, want):
    q = np.asarray(taken["wavenumbers"], np.float64)
    if q.shape != want["wavenumbers"].shape or not np.allclose(
            q, want["wavenumbers"], rtol=1e-9, atol=0):
        return {"scsf_gap": float("inf")}
    return {"scsf_gap": relative_gap(np.asarray(taken["scsf"]).reshape(-1),
                                     want["scsf"])}
