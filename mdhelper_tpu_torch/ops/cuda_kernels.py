r"""
Trig sums and the brute-force pair histogram (CUDA)
===================================================

Counterpart of :mod:`mdhelper_tpu.ops.pallas_kernels`, its two kernels:

* :func:`trig_sums` (kernel ``csrc/trig_sums.cu``): the per-wavevector
  :math:`\sum_j w_j \cos(\mathbf{q}\cdot\mathbf{r}_j)` and
  :math:`\sum_j w_j \sin(\cdot)` of one frame or of ``B`` frames in one
  launch, fast (float32 phases) or exact (the double-float phases of
  :func:`mdhelper_tpu_torch.ops.scattering._exact_phases`).  Its plain
  version is :mod:`mdhelper_tpu_torch.ops.scattering`.
* :func:`pair_histogram` (kernel ``csrc/pair_histogram.cu``): every
  ordered pair of one group binned on ``[0, r_max]`` with the float32
  minimum-image distance, identical atoms included unless an
  ``exclusion`` drops them.  Its plain version is an i-tiled torch sweep
  of the same float32 formula.

Each wrapper launches its kernel for tensors on a CUDA device and runs
its ``*_reference`` twin for tensors on the CPU; any other device
raises.  Nothing falls back: a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in ``.launches``.
"""

import numpy as np
import torch

from .cuda_cell_histogram import (
    _SMEM_BYTES,
    _bin_boundary_constants,
    _device_constants,
    _fast_bin_index,
    _fast_d2_orthorhombic,
    _launch,
    _on_cpu,
)
from .scattering import (
    _TWO_PI_HI,
    _TWO_PI_LO,
    _check_precision,
    _split_wavevectors,
    _tile_sums,
)

__all__ = [
    "trig_sums",
    "trig_sums_reference",
    "trig_workspace",
    "pair_histogram",
    "pair_histogram_reference",
]

#: atoms a trig-sums block sums (a multiple of the kernel's 256-atom
#: staging step): 49 slices at 100k atoms, 5,292 blocks of 256
#: wavevectors for two frames of 13,824 wavevectors.  Slices of 1,536 to
#: 2,560 atoms ran 3-4 % faster than 4,096 at that shape, 6,144 5 %
#: slower (scripts/compare_op_designs.py on an NVIDIA H100 80GB HBM3,
#: 700 W).
_TRIG_SLICE_ATOMS = 2048
_TRIG_STAGE = 256
#: CUDA's limit on the grid's second and third extents (slices, frames).
_GRID_YZ = 65535

#: the pair-histogram kernel's tile (the i atoms of a block and the j atoms
#: it stages) and its shared memory a j atom (float4 position and int2
#: ids), beside one 4-byte flag and the histogram.
_HIST_TILE, _HIST_SLOT_BYTES = 512, 24
#: CUDA's limit on the grid's first extent (the kernel's tile pairs).
_GRID_X = 2**31 - 1
#: pairs a tile of the plain pair sweep holds at once (2^25: 128 MiB a
#: float32 buffer).
_PAIR_TILE_ELEMENTS = 1 << 25


def _trig_inputs(qs, positions, weights, precision, qs_lo):
    """Float32 frames ``(B, N, 3)`` (and whether one frame was given),
    wavevectors ``(hi, lo)`` (``lo`` None in fast mode and for float32
    wavevectors without `qs_lo`) and float32 weights, on the positions'
    device."""

    _check_precision(precision)
    positions = torch.as_tensor(positions)
    if positions.ndim not in (2, 3) or positions.shape[-1] != 3:
        raise ValueError("positions must be (N, 3) or (B, N, 3).")
    one_frame = positions.ndim == 2
    device = positions.device
    frames = positions.to(torch.float32)
    if one_frame:
        frames = frames[None]
    qs = torch.as_tensor(qs, device=device)
    if qs.ndim != 2 or qs.shape[1] != 3:
        raise ValueError("qs must be (N_q, 3).")
    if qs_lo is None:
        qs_hi, qs_lo = _split_wavevectors(qs, torch.float32)
    else:
        qs_hi = qs.to(torch.float32)
        qs_lo = torch.as_tensor(qs_lo, device=device).to(torch.float32)
    if precision == "fast":
        qs_lo = None
    if weights is not None:
        weights = torch.as_tensor(weights, device=device).to(torch.float32)
    return frames, one_frame, qs_hi, qs_lo, weights


def _trig_slices(n_atoms):
    """``(atoms a slice, slices)`` of a launch over `n_atoms` atoms."""

    split = min(_TRIG_SLICE_ATOMS, -(-n_atoms // _TRIG_STAGE) * _TRIG_STAGE)
    return split, -(-n_atoms // split)


def trig_workspace(n_frames, n_atoms, n_q, device):
    """A float64 buffer for the partial sums of a :func:`trig_sums` launch
    of up to `n_frames` frames of `n_atoms` atoms and `n_q` wavevectors
    (``(slices, frames, 2, N_q)``: 0.69 GB at 64 frames of 100k atoms and
    13,824 wavevectors).  A caller that launches many times passes it as
    ``workspace=`` to every launch."""

    n_slices = _trig_slices(n_atoms)[1] if n_atoms else 0
    return torch.empty(n_slices * n_frames * 2 * n_q, dtype=torch.float64,
                       device=device)


def trig_sums_reference(qs, positions, weights=None, *, precision="fast",
                        qs_lo=None):
    """Plain-torch version of the kernel (the tiled sweeps of
    :mod:`mdhelper_tpu_torch.ops.scattering`, frame by frame).
    Arguments (apart from `workspace`) and returns as :func:`trig_sums`."""

    frames, one_frame, qs_hi, qs_lo, weights = _trig_inputs(
        qs, positions, weights, precision, qs_lo)
    cos = torch.empty((frames.shape[0], qs_hi.shape[0]),
                      dtype=torch.float32, device=frames.device)
    sin = torch.empty_like(cos)
    for b, p in enumerate(frames):
        cos[b], sin[b] = _tile_sums(qs_hi, qs_lo, p, weights, precision)
    return (cos[0], sin[0]) if one_frame else (cos, sin)


def trig_sums(qs, positions, weights=None, *, precision="fast", qs_lo=None,
              workspace=None):
    r"""Per-wavevector :math:`(\sum_j w_j\cos\mathbf{q}\cdot\mathbf{r}_j,
    \sum_j w_j\sin\mathbf{q}\cdot\mathbf{r}_j)`; the port of the JAX
    package's Pallas ``trig_sums``, batched over frames.

    Parameters
    ----------
    qs : `torch.Tensor` or array-like
        Wavevectors ``(N_q, 3)``.  float64 wavevectors are split into
        float32 ``hi`` and ``lo`` words for the exact path (as
        :func:`~mdhelper_tpu_torch.ops.scattering.trig_sums_frame`
        does); the fast path casts them to float32.
    positions : `torch.Tensor`
        Positions ``(N, 3)`` or frames ``(B, N, 3)``, cast to float32.
    weights : `torch.Tensor`, optional
        Per-particle weights ``(N,)`` (zero on padding).
    precision : `str`, default ``"fast"``
        ``"fast"`` (float32 phases) or ``"exact"`` (double-float phases
        reduced mod :math:`2\pi`).
    qs_lo : `torch.Tensor`, optional
        Low words of the wavevectors ``(N_q, 3)``, given with float32
        `qs` instead of a float64 `qs` (exact path only).

    Returns
    -------
    cos_sum, sin_sum : `torch.Tensor`
        float32 ``(N_q,)`` each, or ``(B, N_q)`` for frames; the atom
        sums are taken in float64 and rounded once.

    A CUDA tensor launches the kernel (one launch for all frames, and one
    added to ``trig_sums.launches``); a CPU tensor runs
    :func:`trig_sums_reference`.
    """

    positions = torch.as_tensor(positions)
    if _on_cpu(positions, "trig_sums"):
        return trig_sums_reference(qs, positions, weights,
                                   precision=precision, qs_lo=qs_lo)
    out = _trig_sums_kernel(qs, positions, weights, precision, qs_lo,
                            workspace)
    trig_sums.launches += 1
    trig_sums.launches_by_precision[precision] += 1
    return out


def _trig_sums_kernel(qs, positions, weights, precision, qs_lo,
                      workspace=None):
    frames, one_frame, qs_hi, qs_lo, weights = _trig_inputs(
        qs, positions, weights, precision, qs_lo)
    device = frames.device
    b, n, _ = frames.shape
    n_q = qs_hi.shape[0]
    if weights is not None and weights.shape != (n,):
        raise ValueError("weights must be (N,).")
    cos = torch.zeros((b, n_q), dtype=torch.float32, device=device)
    sin = torch.zeros_like(cos)
    if b and n and n_q:
        split, n_slices = _trig_slices(n)
        if n_slices > _GRID_YZ or b > _GRID_YZ:
            raise ValueError(
                f"{b} frames of {n} atoms exceed the kernel's grid.")
        shape = (n_slices, b, 2, n_q)
        if workspace is None:
            partial = torch.empty(shape, dtype=torch.float64, device=device)
        else:
            size = n_slices * b * 2 * n_q
            if (workspace.dtype != torch.float64
                    or workspace.device != device
                    or workspace.numel() < size):
                raise ValueError(
                    f"the workspace must hold {size} float64 values on "
                    f"{device}.")
            partial = workspace.view(-1)[:size].view(shape)
        _launch("trig_sums_launch", device, frames.contiguous(),
                qs_hi.contiguous(),
                None if qs_lo is None else qs_lo.contiguous(),
                None if weights is None else weights.contiguous(),
                partial, cos, sin, b, n, n_q, split,
                int(precision == "exact"), _TWO_PI_HI, _TWO_PI_LO)
    return (cos[0], sin[0]) if one_frame else (cos, sin)


#: kernel launches made by :func:`trig_sums` (CUDA tensors only); a run
#: sets it to 0 and reads it back to show that its path went through the
#: kernel.  ``launches_by_precision`` splits the same count by precision.
trig_sums.launches = 0
trig_sums.launches_by_precision = {"exact": 0, "fast": 0}


def _hist_inputs(positions, box, r_max, n_bins, exclusion):
    """Float32 positions ``(N, 3)``, the box lengths as float32, the
    fast "zero" constants and the exclusion ``(e0, e1)`` or None."""

    positions = torch.as_tensor(positions)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError("positions must be (N, 3).")
    if isinstance(box, torch.Tensor):
        box = box.cpu().numpy()
    lengths = np.asarray(box, dtype=np.float64).astype(np.float32)
    if lengths.shape != (3,) or not (lengths > 0).all():
        raise ValueError("box must hold 3 positive lengths.")
    if not float(r_max) > 0.0 or int(n_bins) < 1:
        raise ValueError("r_max must be positive and n_bins at least 1.")
    if exclusion is not None:
        exclusion = tuple(int(e) for e in exclusion)
        if len(exclusion) != 2 or min(exclusion) < 1:
            raise ValueError(
                "exclusion must be None or (e0, e1), both >= 1.")
    consts = _bin_boundary_constants(r_max, int(n_bins))
    return positions.to(torch.float32), lengths, consts, exclusion


def pair_histogram_reference(positions, box, r_max, n_bins, *,
                             exclusion=None):
    """Plain-torch version of the kernel: the same float32 formula over
    tiles of i rows against every j.  Arguments and returns as
    :func:`pair_histogram`."""

    pos, lengths, consts, exclusion = _hist_inputs(
        positions, box, r_max, n_bins, exclusion)
    device = pos.device
    n_bins = int(n_bins)
    box_t = torch.as_tensor(lengths, device=device)
    consts = _device_constants(consts, device)
    n = pos.shape[0]
    counts = torch.zeros(n_bins, dtype=torch.int64, device=device)
    tile = max(1, _PAIR_TILE_ELEMENTS // max(n, 1))
    j_tiles = None
    if exclusion is not None:
        j_tiles = torch.arange(n, device=device) // exclusion[1]
    for lo in range(0, n, tile):
        pi = pos[lo:lo + tile]
        d2 = _fast_d2_orthorhombic(pi[:, None, :], pos[None, :, :], box_t)
        idx = _fast_bin_index(d2, consts, n_bins)
        keep = idx < n_bins
        if exclusion is not None:
            i_tiles = torch.arange(lo, lo + pi.shape[0],
                                   device=device) // exclusion[0]
            keep &= i_tiles[:, None] != j_tiles[None, :]
        counts += torch.bincount(idx[keep].to(torch.int64),
                                 minlength=n_bins)
    return counts


def pair_histogram(positions, box, r_max, n_bins, *, exclusion=None):
    r"""Brute-force all-pairs minimum-image distance histogram with
    ``n_bins`` uniform bins on ``[0, r_max]``; the port of the JAX
    package's Pallas ``pair_histogram``.

    Parameters
    ----------
    positions : `torch.Tensor`
        Coordinates ``(N, 3)``, cast to float32; any values (the minimum
        image is taken per pair, as the JAX kernel takes it).
    box : array-like or `torch.Tensor`
        Orthorhombic box lengths (3 values; an argument of the launch,
        not baked into the kernel).
    r_max : `float`
        Histogram range ``[0, r_max]``.
    n_bins : `int`
        Number of uniform bins.
    exclusion : `tuple`, optional
        ``(e0, e1)``: ordered pairs with ``i // e0 == j // e1`` (global
        indices) are dropped; ``(1, 1)`` drops identical atoms.  With
        None every ordered pair counts, identical atoms in bin 0.

    Returns
    -------
    counts : `torch.Tensor`
        int64 ``(n_bins,)`` ordered-pair counts.  Binning is the float32
        formula of the JAX kernel and of the cell kernels' fast policy:
        each component ``d - L round(d / L)`` (half to even), ``sqrt`` of
        the squares summed left to right, ``trunc(dist * f32(n_bins /
        r_max))``.  The JAX kernel accumulates in float32, exact only
        while every bin stays under :math:`2^{24}`; these counts are
        integers at any size.

    A CUDA tensor launches the kernel (and adds one to
    ``pair_histogram.launches``); a CPU tensor runs
    :func:`pair_histogram_reference`.
    """

    positions = torch.as_tensor(positions)
    if _on_cpu(positions, "pair_histogram"):
        return pair_histogram_reference(positions, box, r_max, n_bins,
                                        exclusion=exclusion)
    counts = _pair_histogram_kernel(positions, box, r_max, n_bins,
                                    exclusion)
    pair_histogram.launches += 1
    return counts


def _pair_histogram_kernel(positions, box, r_max, n_bins, exclusion):
    pos, lengths, consts, exclusion = _hist_inputs(
        positions, box, r_max, n_bins, exclusion)
    n_bins = int(n_bins)
    smem = _HIST_TILE * _HIST_SLOT_BYTES + 4 + 4 * n_bins
    if smem > _SMEM_BYTES:
        raise ValueError(
            f"{n_bins} bins need {smem} bytes of shared memory a block "
            f"(at most {_SMEM_BYTES}).")
    n = pos.shape[0]
    n_tiles = -(-n // _HIST_TILE)
    if n_tiles * (n_tiles + 1) // 2 > _GRID_X:
        raise ValueError(f"{n} atoms exceed the kernel's grid.")
    counts = torch.zeros(n_bins, dtype=torch.int64, device=pos.device)
    if n:
        e0, e1 = exclusion or (1, 1)
        _launch("pair_histogram_launch", pos.device, pos.contiguous(),
                counts, n, n_bins, int(exclusion is not None), e0, e1,
                *lengths, consts[1], _fast_d2_cut(consts[1], n_bins))
    return counts


def _fast_d2_cut(inv_dr, n_bins):
    """The largest float32 ``d2`` whose fast "zero" bin
    ``trunc(min(f32(sqrt(d2)) * inv_dr, n_bins))`` is below `n_bins`
    (the bin is non-decreasing in ``d2``): the kernel bins a pair iff its
    ``d2`` is at most this.  Walks float bit patterns from
    ``(n_bins / inv_dr)^2``, IEEE float32 sqrt and product as on the
    card."""

    inv, top = np.float32(inv_dr), np.float32(n_bins)
    big = np.finfo(np.float32).max

    def binned(d2):
        return np.float32(np.sqrt(d2)) * inv < top

    d2 = np.float32(min((float(n_bins) / float(inv)) ** 2, float(big)))
    for _ in range(64):
        if binned(d2):
            up = np.nextafter(d2, np.float32(np.inf))
            if not binned(up):
                return d2
            d2 = up
        else:
            d2 = np.nextafter(d2, np.float32(0.0))
    raise RuntimeError(f"no d2 cut found for {n_bins} bins, inv_dr {inv}.")


#: kernel launches made by :func:`pair_histogram` (CUDA tensors only),
#: read the same way as ``trig_sums.launches``.
pair_histogram.launches = 0
