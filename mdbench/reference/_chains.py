"""Unwrapped linear chains, shared by the polymer references.

Chains are stored one after another, ``n_monomers`` consecutive atoms a
chain, wrapped atom by atom.  The first frame is made whole along the
bonds (each monomer is its predecessor plus the minimum image of the
bond), and every later frame adds the minimum image of each monomer's
step from the frame before.  The analyses' outputs compared here do not
depend on which image of a whole chain is taken.
"""

import numpy as np
import torch

from mdbench.reference._common import min_image, unwrap

_cache = {}


def unwrapped_chains(frames, dimensions, spec, device, dtype):
    """``(T, n_chains, n_monomers, 3)`` unwrapped positions in `dtype`
    (kept for the other references of the same frames)."""

    m = int(spec["kwargs"]["n_chains"])
    n_p = int(spec["kwargs"]["n_monomers"])
    key = (id(frames), m, n_p, str(device), dtype)
    if key in _cache:
        return _cache[key]
    _cache.clear()
    box = torch.as_tensor(np.asarray(dimensions[:3], np.float64),
                          dtype=dtype, device=device)
    pos = torch.as_tensor(frames, device=device).to(dtype)
    first = pos[0].reshape(m, n_p, 3)
    bonds = min_image(first[:, 1:] - first[:, :-1], box)
    whole = torch.cat((first[:, :1], first[:, :1] + torch.cumsum(bonds, 1)),
                      dim=1)
    chains = unwrap(pos, box, seed=whole.reshape(-1, 3)).reshape(
        len(pos), m, n_p, 3)
    _cache[key] = chains
    return chains


def autocorrelation(series):
    """``C(m)``, the mean over origins t and the leading axes of
    ``x(t) . x(t + m)`` for a ``(T, ..., 3)`` series, for every lag."""

    n_frames = len(series)
    out = np.empty(n_frames)
    for m in range(n_frames):
        out[m] = float((series[m:] * series[:n_frames - m]).sum(-1).mean())
    return out
