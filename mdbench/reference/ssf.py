"""Static structure factor on the cubic box's wavevector grid.

``S(q) = < |sum_j exp(i q . r_j)|^2 > / N`` over the frames, for the
wavevectors ``q = 2 pi n / L``, each ``n_x, n_y, n_z`` in ``0 ..
n_points - 1``, averaged over equal wavenumbers and sorted by them (the
``sort=True, unique=True`` form of the results).  The phase factor of a
lattice wavevector is the product of its three axes' factors, so each
frame's sums are one complex product of ``(atoms, n^2)`` and ``(atoms,
n)`` tables, in the complex type of `dtype`.
"""

import numpy as np
import torch

from mdbench.reference._common import grouped_by_n2, lattice_axis, \
    relative_gap

#: atoms a block of the sums takes.
ATOM_BLOCK = 16384


def lattice_power(positions, box, n_points, dtype, round_to_float32=False):
    """``sum over the leading axis of |sum_j exp(i q . r_j)|^2`` on the
    ``(n, n, n)`` grid, for `positions` ``(S, n_atoms, 3)`` in `dtype`
    (S sets of atoms: frames, or chains of a frame)."""

    device = positions.device
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    qs = [lattice_axis(n_points, float(box[k]), dtype, device,
                       round_to_float32) for k in range(3)]
    power = torch.zeros((n_points,) * 3, dtype=dtype, device=device)
    n_sets, n_atoms = positions.shape[:2]
    per_block = max(1, ATOM_BLOCK // n_atoms)
    for s0 in range(0, n_sets, per_block):
        block = positions[s0:s0 + per_block]
        rho = None
        for a0 in range(0, n_atoms, ATOM_BLOCK):
            p = block[:, a0:a0 + ATOM_BLOCK]
            phases = [p[..., k, None] * qs[k] for k in range(3)]
            e = [torch.complex(torch.cos(x), torch.sin(x)).to(cdtype)
                 for x in phases]
            exy = (e[0][..., :, None] * e[1][..., None, :]).reshape(
                p.shape[0], p.shape[1], -1)
            part = torch.bmm(exy.transpose(1, 2), e[2])
            rho = part if rho is None else rho + part
        power += (rho.real**2 + rho.imag**2).sum(dim=0).reshape(
            (n_points,) * 3)
    return power


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    n_points = int(spec["kwargs"]["n_points"])
    box = np.asarray(dimensions[:3], np.float64)
    power = torch.zeros((n_points,) * 3, dtype=dtype, device=device)
    for frame in frames:
        pos = torch.as_tensor(frame, device=device).to(dtype)
        power += lattice_power(pos[None], box, n_points, dtype)
    n_frames, n_atoms = frames.shape[:2]
    n2, ssf = grouped_by_n2(power.double().cpu().numpy()
                            / (n_frames * n_atoms), n_points)
    return {"wavenumbers": 2 * np.pi * np.sqrt(n2) / box[0], "ssf": ssf}


def judge(taken, want):
    q = np.asarray(taken["wavenumbers"], np.float64)
    if q.shape != want["wavenumbers"].shape or not np.allclose(
            q, want["wavenumbers"], rtol=1e-9, atol=0):
        return {"sq_gap": float("inf")}
    return {"sq_gap": relative_gap(np.asarray(taken["ssf"]).reshape(-1),
                                   want["ssf"])}
