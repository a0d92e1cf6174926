"""The yardstick of the kernels' roofline shares: operations, bytes and
peaks, frozen here so that a redesign of a kernel cannot move it.

Copied from ``chip_smoke.py`` (``OPS_PER_PAIR``, ``TAIL_OPS``,
``trig_ops``, ``SINCOSF_FLOPS``, ``PEAK_F32``, ``PEAK_BYTES``) at commit
f7f3e8cd0aa08483990a67085713f35a76e682d8 and frozen as the algorithms'
least work:

* a cell-list pair histogram needs, for every pair in range and no other,
  the screen, the exact double-float d^2 and the bin tail of the
  orthorhombic exact policy: 23 + 133 + 49 = 205 float32 operations, an
  FMA counted as two (counted in ``csrc/cell_bin.cuh`` at that commit);
  its bytes are the positions read once and the counts written once;
* an exact trig sum needs 66 operations a (wavevector, atom) term, 6 more
  for the low words of float64 wavevectors, 2 more with weights, and
  ``sincosf``'s 31; its bytes are the positions, wavevectors and weights
  read once and the float32 cos and sin sums written once.

The share is the least time (the larger of operations over the float32
peak and bytes over the memory rate) over the device time the kernels
took: it cannot pass 100 % unless the work is counted too high or the
time leaves work out.
"""

#: one H100 SXM's published peaks (NVIDIA's data sheet): float32 outside
#: the tensor cores, and HBM3 bytes/s.
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12

#: float32 operations of one pair in range under the orthorhombic exact
#: policy: screen + exact d^2 + the tail of bins from 0.
PAIR_OPS = 23 + 133 + 49
#: sincosf's operations, an FMA as two.
SINCOSF_FLOPS = 31


def trig_term_ops(lo=False, weights=False):
    """float32 operations of one (wavevector, atom) term of the exact trig
    sums."""

    return 66 + 6 * int(lo) + 2 * int(weights) + SINCOSF_FLOPS


def least_seconds(ops, n_bytes):
    """``(seconds, bound)``: the least time of `ops` float32 operations and
    `n_bytes` bytes on the card, and which of the two bounds it."""

    ops_s, bytes_s = ops / PEAK_F32, n_bytes / PEAK_BYTES
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                 else "bytes")


def pair_histogram_least(pairs, n_frames, n_atoms, n_bins):
    """Least seconds of cell-list sweeps that bin `pairs` pairs in range
    over `n_frames` frames of `n_atoms` float32 positions each side into
    `n_bins` uint64 counts a frame."""

    n_bytes = n_frames * (2 * n_atoms * 3 * 4 + n_bins * 8)
    return least_seconds(pairs * PAIR_OPS, n_bytes)


def self_pair_histogram_least(pairs, n_frames, n_atoms, n_bins):
    """The same for self sweeps, whose frames are read once."""

    n_bytes = n_frames * (n_atoms * 3 * 4 + n_bins * 8)
    return least_seconds(pairs * PAIR_OPS, n_bytes)


def trig_sums_least(n_sets, n_atoms, n_q, lo=False, weights=False):
    """Least seconds of exact trig sums over `n_sets` sets (frames, or
    chains of frames) of `n_atoms` atoms each on `n_q` wavevectors."""

    terms = n_sets * n_atoms * n_q
    n_bytes = (n_sets * n_atoms * 3 * 4 + n_q * 3 * 4 * (1 + int(lo))
               + 4 * n_atoms * int(weights) + n_sets * n_q * 2 * 4)
    return least_seconds(terms * trig_term_ops(lo, weights), n_bytes)
