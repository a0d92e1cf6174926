"""Mean-squared displacements of one group of atoms, unwrapped.

The atoms are unwrapped from the first frame: each frame adds the
minimum image of its step from the frame before.  ``msd_self(m)`` is the
mean over origins t and atoms of ``|r(t + m) - r(t)|^2``, ``msd_cross(m)``
the mean over origins of ``|R(t + m) - R(t)|^2`` with ``R`` the sum of the
atoms' positions, each over 6 (twice the three dimensions), as
``Onsager``'s results give them; taken lag by lag in `dtype`.
"""

import numpy as np
import torch

from mdbench.reference._common import relative_gap, unwrap

#: origins a block of a lag takes.
ORIGIN_BLOCK = 16


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    box = torch.as_tensor(np.asarray(dimensions[:3], np.float64),
                          dtype=dtype, device=device)
    pos = unwrap(torch.as_tensor(frames, device=device).to(dtype), box)
    total = pos.sum(dim=1)
    n_frames = len(pos)
    msd_self = np.zeros(n_frames)
    msd_cross = np.zeros(n_frames)
    for m in range(1, n_frames):
        acc = torch.zeros((), dtype=dtype, device=device)
        for t0 in range(0, n_frames - m, ORIGIN_BLOCK):
            t1 = min(t0 + ORIGIN_BLOCK, n_frames - m)
            d = pos[t0 + m:t1 + m] - pos[t0:t1]
            acc += (d * d).sum()
        msd_self[m] = float(acc) / ((n_frames - m) * pos.shape[1])
        d = total[m:] - total[:n_frames - m]
        msd_cross[m] = float((d * d).sum()) / (n_frames - m)
    return {"msd_self": msd_self / 6, "msd_cross": msd_cross / 6,
            "n_atoms": pos.shape[1]}


def judge(taken, want):
    """``msd_self_gap``: the widest relative gap of the self MSD;
    ``msd_cross_gap``: the widest gap of the collective MSD over the
    largest of its reference's value, the value uncorrelated atoms would
    give it (the atoms' count times the self MSD, smooth in the lag where
    the collective MSD of a random walk is not) and that value's median
    over the lags (at lag 0 both are 0, and an FFT's residual there is
    about 1e-16 of the squared sum of the positions)."""

    self_got = np.asarray(taken["msd_self"], np.float64).reshape(-1)
    cross = np.asarray(taken["msd_cross"], np.float64).reshape(-1)
    want_cross = want["msd_cross"]
    out = {"msd_self_gap": relative_gap(self_got, want["msd_self"])}
    if cross.shape != want_cross.shape or not np.all(np.isfinite(cross)):
        out["msd_cross_gap"] = float("inf")
        return out
    uncorrelated = want["n_atoms"] * want["msd_self"]
    scale = np.maximum(np.maximum(np.abs(want_cross), uncorrelated),
                       np.median(uncorrelated))
    out["msd_cross_gap"] = float(np.max(np.abs(cross - want_cross) / scale))
    return out
