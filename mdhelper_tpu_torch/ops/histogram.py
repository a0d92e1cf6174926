"""
Brute-force pair-distance histogram
===================================

Torch counterpart of the exact part of :mod:`mdhelper_tpu.ops.histogram`:
squared minimum-image distances of float32 coordinates in error-free
double-float arithmetic, in orthorhombic boxes (per-axis image
multiples) and triclinic ones (the 27-candidate image search), and
``numpy.histogram``-compatible binning against the exact uniform edges
(bin k is ``[e_k, e_{k+1})``, the last bin closed).

This all-pairs sweep is the port's oracle: the tests and
``chip_smoke.py`` hold the cell-list kernels
(:mod:`mdhelper_tpu_torch.ops.cuda_cell_histogram`) against it, the way
the JAX package holds its Pallas kernels against the XLA sweep.

A triclinic box is the ``(3, 3)`` lower-triangular float32 matrix whose
rows are the box vectors
(:func:`mdhelper_tpu_torch.algorithm.topology.triclinic_matrices`).
The JAX package forms fractional coordinates with float32 matrix
products; here they are written out elementwise in a fixed order
(:func:`_row_times`), so the base image multiple cannot depend on a
BLAS library's summation order.
"""

import numpy as np
import torch

from .doublefloat import (
    df_add,
    df_ge,
    df_lt,
    df_min,
    df_sub,
    df_sum3,
    df_square,
    f32_constant,
    fma32,
    two_diff,
    two_prod,
)

__all__ = ["radial_histogram_frame", "displacement_histogram_frame"]

#: the 26 non-zero image shifts in {-1, 0, 1}^3, lexicographic (the
#: triclinic minimum-image search; the zero shift is tried first).
_IMAGE_SHIFTS = [
    (sx, sy, sz)
    for sx in (-1, 0, 1)
    for sy in (-1, 0, 1)
    for sz in (-1, 0, 1)
    if (sx, sy, sz) != (0, 0, 0)
]


def _inv3(m):
    """Closed-form inverse (adjugate over determinant) of ``(..., 3,
    3)`` matrices, term for term as the JAX package's ``_inv3``."""

    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = -(d * i - f * g)
    cc = d * h - e * g
    cd = -(b * i - c * h)
    ce = a * i - c * g
    cf = -(a * h - b * g)
    cg = b * f - c * e
    ch = -(a * f - c * d)
    ci = a * e - b * d
    det = a * ca + b * cb + c * cc
    adj = torch.stack(
        (
            torch.stack((ca, cd, cg), dim=-1),
            torch.stack((cb, ce, ch), dim=-1),
            torch.stack((cc, cf, ci), dim=-1),
        ),
        dim=-2,
    )
    return adj / det[..., None, None]


def _row_times(v, m):
    """``v @ m`` for row vectors ``v`` ``(..., 3)`` and a matrix ``m``
    ``(..., 3, 3)`` broadcast against them, written out elementwise:
    column ``j`` is ``(v0 m0j + v1 m1j) + v2 m2j``."""

    cols = []
    for j in range(3):
        acc = v[..., 0] * m[..., 0, j]
        acc = acc + v[..., 1] * m[..., 1, j]
        acc = acc + v[..., 2] * m[..., 2, j]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _exact_d2_orthorhombic(p1, p2, box, n_axes=3):
    """Squared minimum-image distances in double-float.  Assumes
    wrapped inputs (image multiple in {-1, 0, 1}, so ``m * box`` is
    exact).  ``p1``/``p2`` are broadcast-compatible ``(..., 3)`` float32
    tensors; ``box`` is a float32 ``(3,)`` tensor, or lengths ``(..., 1,
    3)`` that broadcast against them (a box a frame).  With ``n_axes=2``
    only the first two components are summed, by one ``df_add`` (the
    JAX package's 2-D ``_bin_exact``)."""

    components = []
    for k in range(n_axes):
        s, e = two_diff(p1[..., k], p2[..., k])
        # torch.round rounds half to even, like jnp.round.
        m = torch.round(s / box[..., k])
        d = df_sub((s, e), (m * box[..., k], torch.zeros_like(s)))
        components.append(df_square(d))
    if n_axes == 2:
        return df_add(*components)
    return df_sum3(*components)


def _exact_d2_triclinic(p1, p2, box, inv=None):
    """Squared minimum-image distances in a triclinic cell, in
    double-float: the base image multiple ``n0`` comes from rounding the
    float32 fractional displacement, and all 27 candidates around it
    are evaluated exactly, the minimum taken in double-float (the JAX
    package's ``_exact_d2_triclinic``, with ``n0`` formed elementwise
    instead of by a matrix product; the window absorbs a +-1 difference
    in ``n0``).  ``box`` is the float32 ``(3, 3)`` lower-triangular
    matrix; its zeros above the diagonal are skipped.  ``inv`` is its
    float32 inverse, :func:`_inv3` of ``box`` unless given (the tri_pp
    kernels take one computed once a frame, and so does their plain
    version)."""

    if inv is None:
        inv = _inv3(box)
    s_hi, s_lo = [], []
    for k in range(3):
        s, e = two_diff(p1[..., k], p2[..., k])
        s_hi.append(s)
        s_lo.append(e)
    n0 = torch.round(_row_times(torch.stack(s_hi, dim=-1), inv))

    best = None
    for shift in [(0, 0, 0)] + _IMAGE_SHIFTS:
        m = [n0[..., j] + float(shift[j]) for j in range(3)]
        components = []
        for k in range(3):
            # t = sum_{j >= k} m_j * box[j, k] (lower-triangular).
            t = two_prod(m[k], box[k, k])
            for j in range(k + 1, 3):
                t = df_add(t, two_prod(m[j], box[j, k]))
            d = df_sub((s_hi[k], s_lo[k]), t)
            components.append(df_square(d))
        d2 = df_sum3(*components)
        best = d2 if best is None else df_min(best, d2)
    return best


def _exact_d2(p1, p2, box):
    """Exact squared minimum-image distances for an orthorhombic
    ``(3,)`` or a triclinic ``(3, 3)`` float32 box."""

    if box.ndim == 2:
        return _exact_d2_triclinic(p1, p2, box)
    return _exact_d2_orthorhombic(p1, p2, box)


def _uniform_edge_constants(edges, device):
    """Double-float splits of the uniform-edge constants ``e0^2``,
    ``2 e0 h`` and ``h^2`` (from the float64 edges), with the float32
    ``e0`` and ``1 / h`` of the index estimate."""

    edges = np.asarray(edges, dtype=np.float64)
    n_bins = len(edges) - 1
    e0 = edges[0]
    h = (edges[-1] - edges[0]) / n_bins

    def split(x):
        hi = np.float32(x)
        return (f32_constant(hi, device),
                f32_constant(x - np.float64(hi), device))

    return (
        split(e0 * e0),
        split(2.0 * e0 * h),
        split(h * h),
        f32_constant(e0, device),
        f32_constant(1.0 / h, device),
    )


def _exact_bin_indices(p1, p2, box, edges, *, elementwise=False):
    """Exact bin index of every pair of the ``(N1, N2)`` block (spill
    index ``n_bins`` for out-of-range pairs), replicating
    ``mdhelper_tpu.ops.histogram._exact_bin_indices`` operation for
    operation.  With ``elementwise=True``, `p1` and `p2` pair row for
    row instead (broadcast-compatible ``(..., 3)`` -> ``(...)``
    displacement indices)."""

    n_bins = len(edges) - 1
    device = p1.device
    c0, c1, c2, e0_f32, inv_h = _uniform_edge_constants(edges, device)
    if not elementwise:
        p1, p2 = p1[:, None, :], p2[None, :, :]
    d2 = _exact_d2(p1, p2, box)

    def boundary(k):
        kf = k.to(torch.float32)
        k2 = kf * kf
        t1 = two_prod(kf, c1[0])
        t2 = two_prod(k2, c2[0])
        acc = df_add(c0, (t1[0], t1[1] + kf * c1[1]))
        return df_add(acc, (t2[0], t2[1] + k2 * c2[1]))

    dist = torch.sqrt(torch.clamp(d2[0], min=0.0))
    # float -> int32 truncates toward zero, like convert_element_type.
    idx = torch.clamp(((dist - e0_f32) * inv_h).to(torch.int32), 0, n_bins)
    idx = (
        idx
        + df_ge(d2, boundary(idx + 1)).to(torch.int32)
        - df_lt(d2, boundary(idx)).to(torch.int32)
    )
    b_last = boundary(torch.full_like(idx, n_bins))
    b_first = boundary(torch.zeros_like(idx))
    at_last = (d2[0] == b_last[0]) & (d2[1] == b_last[1])
    in_range = df_ge(d2, b_first) & (df_lt(d2, b_last) | at_last)
    return torch.where(
        in_range, torch.clamp(idx, max=n_bins - 1), n_bins
    )


def _root(d2):
    """Correctly rounded square root in the dtype of `d2` (taken in
    float64: torch's float32 ``sqrt`` on the CPU is not always correctly
    rounded, numpy's, XLA's and CUDA's are)."""

    return torch.sqrt(d2.double()).to(d2.dtype)


def _image_shift(delta, box):
    """Integer image multiples for an orthorhombic fold, with
    non-positive box lengths treated as aperiodic (vacuum systems must
    not fold: a zero length would otherwise give NaNs), as the JAX
    package's ``_image_shift``."""

    period = torch.where(box > 0, box, torch.inf)
    return torch.where(box > 0, torch.round(delta / period), 0.0)


def _sweep_elements(device) -> int:
    """float32 elements of one ``(rows, N, 3)`` intermediate of a dense
    pair sweep's row block on `device`: 2^27 (512 MiB, a few of which
    live at once on an 80 GB card) on a GPU, where fewer, larger blocks
    launch fewer kernels, and 2^21 (8 MiB) on the CPU, where a block
    stays in cache."""

    return 1 << 27 if torch.device(device).type == "cuda" else 1 << 21


def _row_blocks(n_rows: int, n_cols: int, device) -> list:
    """``(start, stop)`` of the row blocks of a dense pair sweep of
    `n_rows` rows against `n_cols` columns on `device`: each block's
    ``(rows, n_cols, 3)`` float32 intermediate holds at most
    :func:`_sweep_elements` elements (at least one row a block)."""

    rows = max(1, _sweep_elements(device) // (3 * max(n_cols, 1)))
    return [(lo, min(lo + rows, n_rows)) for lo in range(0, n_rows, rows)]


def _contact_map(pts, box, cut2):
    """``(N, N)`` bool: points `pts` ``(N, 3)`` within the cutoff (squared
    `cut2`, in the dtype of `pts`) of each other under the minimum image
    of `box` (:func:`_min_image_vectors`), the diagonal included, built in
    row blocks (:func:`_row_blocks`)."""

    n = pts.shape[0]
    return torch.cat([
        _norm2(_min_image_vectors(pts[lo:hi, None, :] - pts[None, :, :],
                                  box)) <= cut2
        for lo, hi in _row_blocks(n, n, pts.device)
    ])


def _norm2(v):
    """Squared lengths of float32 vectors `v` ``(..., 3)`` as XLA's CPU
    backend forms the JAX package's reductions: ``fma(z, z, fma(y, y, x *
    x))``, each sum rounded once with its product
    (:func:`~mdhelper_tpu_torch.ops.doublefloat.fma32`)."""

    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return fma32(z, z, fma32(y, y, x * x))


def _min_image_distance(delta, box):
    """Minimum-image lengths of displacements `delta` ``(..., 3)`` in
    the dtype of `delta`, for the boxes of :func:`_min_image_vectors`
    (the smallest of the 27 images of a triclinic box), as the JAX
    package's function, with a correctly rounded root."""

    v = _min_image_vectors(delta, box)
    return _root((v * v).sum(dim=-1))


def _min_image_vectors(delta, box):
    """Minimum-image displacement vectors of `delta` ``(..., 3)`` in its
    dtype, as the JAX package's ``_min_image_vectors``.  `box` holds
    orthorhombic lengths ``(..., 3)`` (non-positive lengths are aperiodic
    axes and do not fold), or lower-triangular box matrices when its last
    two axes are ``(3, 3)``; its leading axes broadcast against `delta`'s
    (per-frame boxes of a batch of frames as ``(B, 1, ..., 3)`` or ``(B,
    1, ..., 3, 3)``).  Lengths fold each component by its length; a
    matrix gives a base image by the fractional fold, and the first of
    the 26 neighbouring images shorter than the best so far replaces
    it."""

    if box.shape[-2:] == (3, 3):
        frac = _row_times(delta, _inv3(box))
        base = _row_times(frac - torch.round(frac), box)
        best, best_d2 = base, (base * base).sum(dim=-1)
        shifts = torch.tensor(_IMAGE_SHIFTS, dtype=delta.dtype,
                              device=delta.device)
        for w in shifts:
            cand = base + _row_times(w, box)
            d2 = (cand * cand).sum(dim=-1)
            take = d2 < best_d2
            best = torch.where(take[..., None], cand, best)
            best_d2 = torch.minimum(best_d2, d2)
        return best
    return delta - box * _image_shift(delta, box)


def radial_histogram_frame(pos1, pos2, box, edges, *, exclusion=None,
                           tile=2048):
    r"""Exact all-pairs histogram of one frame's minimum-image distances.

    Parameters
    ----------
    pos1, pos2 : `torch.Tensor`
        float32 positions ``(N1, 3)`` and ``(N2, 3)``, wrapped into the
        box (orthorhombic; the triclinic search takes any positions).
    box : `torch.Tensor`
        float32 orthorhombic box lengths ``(3,)``, or a ``(3, 3)``
        lower-triangular box matrix.
    edges : array-like
        Uniform float64 bin edges ``(n_bins + 1,)``.
    exclusion : `tuple`, optional
        ``(e0, e1)``: drop pairs with ``i // e0 == j // e1``.
    tile : `int`
        Rows of ``pos1`` per pair block (bounds memory).

    Returns
    -------
    counts : `torch.Tensor`
        int64 counts ``(n_bins,)``.
    """

    n_bins = len(edges) - 1
    pos1 = pos1.to(torch.float32)
    pos2 = pos2.to(torch.float32)
    box = box.to(torch.float32)
    counts = torch.zeros(n_bins + 1, dtype=torch.int64, device=pos1.device)
    j_idx = torch.arange(pos2.shape[0], device=pos1.device)
    for i0 in range(0, pos1.shape[0], tile):
        a = pos1[i0:i0 + tile]
        idx = _exact_bin_indices(a, pos2, box, edges)
        if exclusion is not None:
            e0, e1 = exclusion
            i_idx = torch.arange(i0, i0 + a.shape[0], device=pos1.device)
            keep = (i_idx[:, None] // e0) != (j_idx[None, :] // e1)
            idx = torch.where(keep, idx, n_bins)
        counts += torch.bincount(idx.reshape(-1), minlength=n_bins + 1)
    return counts[:n_bins]


def displacement_histogram_frame(pos1, pos2, box, edges):
    r"""Exact histogram of elementwise minimum-image displacement
    lengths :math:`|\mathbf{r}_{1,i} - \mathbf{r}_{2,i}|` -- the Van
    Hove self part (exact precision of the JAX package's function).

    Parameters
    ----------
    pos1, pos2 : `torch.Tensor`
        float32 positions of the same atoms in the same order,
        ``(..., N, 3)``, wrapped into the box (orthorhombic; the
        triclinic search takes any positions).
    box : `torch.Tensor`
        float32 orthorhombic box lengths ``(3,)``, or a ``(3, 3)``
        lower-triangular box matrix; or orthorhombic lengths ``(..., 1,
        3)``, one box per leading index.
    edges : array-like
        Uniform float64 bin edges ``(n_bins + 1,)``.

    Returns
    -------
    counts : `torch.Tensor`
        int64 counts ``(..., n_bins)``, one histogram per leading index.
    """

    n_bins = len(edges) - 1
    idx = _exact_bin_indices(
        pos1.to(torch.float32), pos2.to(torch.float32),
        box.to(torch.float32), edges, elementwise=True,
    )
    lead = idx.shape[:-1]
    rows = idx.reshape(-1, idx.shape[-1])
    # One bincount for every leading index: offset each row's bins.
    offset = torch.arange(rows.shape[0], device=rows.device)[:, None]
    flat = (rows + offset * (n_bins + 1)).reshape(-1)
    counts = torch.bincount(flat, minlength=rows.shape[0] * (n_bins + 1))
    return counts.reshape(*lead, n_bins + 1)[..., :n_bins]
