"""Pair counts of a self radial distribution function.

The count of bin k is the number of ordered pairs (i, j), i != j, whose
minimum-image distance d in the orthorhombic box lies in ``[e_k,
e_{k+1})`` of the uniform edges ``numpy.linspace(lo, hi, n_bins + 1)``,
the last bin closed, summed over the frames.  The squared distance is
formed in `dtype` from the float32 coordinates (in float64: exactly, for
float32 inputs, up to the last rounding of the sum) and held against the
squared edges in `dtype`, over a cell list of cells at least ``hi`` wide
(each unordered pair once, then doubled).
"""

import itertools

import numpy as np
import torch

#: cells a block of the sweep takes (bounds the temporaries).
CELL_BLOCK = 512


def _cell_table(pos, box, n_cells):
    """``(table, cell_xyz)``: the positions sorted into a ``(cells,
    capacity, 3)`` table padded with NaN, and each cell's integer
    coordinates."""

    width = box / torch.as_tensor(n_cells, dtype=pos.dtype,
                                  device=pos.device)
    ci = torch.floor(pos / width).long()
    for k in range(3):
        ci[:, k].clamp_(0, n_cells[k] - 1)
    cid = (ci[:, 0] * n_cells[1] + ci[:, 1]) * n_cells[2] + ci[:, 2]
    total = n_cells[0] * n_cells[1] * n_cells[2]
    order = torch.argsort(cid, stable=True)
    cid = cid[order]
    occupancy = torch.bincount(cid, minlength=total)
    start = torch.cumsum(occupancy, 0) - occupancy
    rank = torch.arange(len(cid), device=pos.device) - start[cid]
    capacity = int(occupancy.max())
    table = torch.full((total, capacity, 3), float("nan"), dtype=pos.dtype,
                       device=pos.device)
    table[cid, rank] = pos[order]
    idx = torch.arange(total, device=pos.device)
    xyz = torch.stack((idx // (n_cells[1] * n_cells[2]),
                       (idx // n_cells[2]) % n_cells[1],
                       idx % n_cells[2]), dim=1)
    return table, xyz


def _half_shell():
    """The cell itself, then the 13 neighbour offsets after it in
    lexicographic order: each unordered pair of neighbouring cells once."""

    return [(0, 0, 0)] + [o for o in itertools.product((-1, 0, 1), repeat=3)
                          if o > (0, 0, 0)]


def bin_counts(d2, bounds2, n_bins):
    """Counts of the squared distances `d2` (1-D) in the bins whose squared
    edges are `bounds2` (``n_bins + 1``, the last bin closed); NaN and
    out-of-range values count nowhere."""

    keep = (d2 >= bounds2[0]) & (d2 <= bounds2[-1])
    d2 = d2[keep]
    width = (bounds2[-1].sqrt() - bounds2[0].sqrt()) / n_bins
    k = torch.floor((d2.sqrt() - bounds2[0].sqrt()) / width).long()
    k.clamp_(0, n_bins - 1)
    k += ((k < n_bins - 1) & (d2 >= bounds2[(k + 1).clamp(max=n_bins)])).long()
    k -= (d2 < bounds2[k]).long()
    k.clamp_(0, n_bins - 1)
    return torch.bincount(k, minlength=n_bins)


def frame_counts(pos, box, r_max, bounds2, n_bins):
    """Unordered pairs of one frame ``(N, 3)`` in each bin.

    A float32 screen first drops the pairs of each block whose float32
    squared distance lies beyond the last edge by more than a relative
    1e-4 (far above float32's rounding of the squared distance), so that
    the squared distances in `dtype` are formed only for the pairs that
    can be in range."""

    n_cells = [int(float(length) // r_max) for length in box]
    if min(n_cells) < 3:
        raise ValueError("the cell list needs a box of 3 cells or more an "
                         "axis")
    table, xyz = _cell_table(pos, box, n_cells)
    table32, box32 = table.to(torch.float32), box.to(torch.float32)
    cut32 = float(bounds2[-1]) * (1 + 1e-4)
    dims = torch.as_tensor(n_cells, device=pos.device)
    capacity = table.shape[1]
    upper = torch.triu(torch.ones(capacity, capacity, dtype=torch.bool,
                                  device=pos.device), diagonal=1)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=pos.device)
    for offset in _half_shell():
        other = (xyz + torch.as_tensor(offset, device=pos.device)) % dims
        other = (other[:, 0] * dims[1] + other[:, 1]) * dims[2] + other[:, 2]
        for lo in range(0, len(table), CELL_BLOCK):
            hi = min(lo + CELL_BLOCK, len(table))
            near = table32[other[lo:hi]]
            d = table32[lo:hi, :, None, :] - near[:, None, :, :]
            d -= box32 * torch.round(d / box32)
            screen = (d * d).sum(dim=-1) <= cut32
            if offset == (0, 0, 0):
                screen &= upper
            c, i, j = screen.nonzero(as_tuple=True)
            d = table[lo + c, i] - table[other[lo + c], j]
            d = d - box * torch.round(d / box)
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            counts += bin_counts(d2, bounds2, n_bins)
    return counts


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    kw = spec["kwargs"]
    n_bins = int(kw["n_bins"])
    lo, hi = (float(x) for x in kw["range"])
    if list(kw.get("exclusion") or ()) != [1, 1]:
        raise ValueError("the reference counts a self RDF with exclusion "
                         "(1, 1)")
    box = torch.as_tensor(np.asarray(dimensions[:3], np.float64),
                          dtype=dtype, device=device)
    edges = np.linspace(lo, hi, n_bins + 1)
    bounds2 = torch.as_tensor(edges, dtype=dtype, device=device) ** 2
    counts = torch.zeros(n_bins, dtype=torch.int64, device=device)
    for frame in frames:
        pos = torch.as_tensor(frame, device=device).to(dtype)
        counts += frame_counts(pos, box, hi, bounds2, n_bins)
    return {"counts": 2 * counts.cpu().numpy()}


def judge(taken, want):
    got = np.asarray(taken["counts"]).reshape(-1)
    if got.shape != want["counts"].shape:
        return {"rdf_count_diff": float("inf")}
    return {"rdf_count_diff": float(np.abs(got.astype(np.int64)
                                           - want["counts"]).sum())}
