r"""
Cell-list pair histograms (CUDA)
================================

Counterpart of :mod:`mdhelper_tpu.ops.pallas_cell_histogram`, every
mode of its two cell-list kernels, in any periodic box:

* the self-group sweep (:func:`cell_pair_histogram`, kernel
  ``csrc/cell_pair_histogram.cu``): each home cell against its
  half-shell neighbour row, counts doubled to ordered pairs, or -- in a
  small box whose grid has no half table -- against its deduped full
  row, ordered pairs counted once; with an optional ``(e, e)`` tile
  exclusion or an asymmetric ``(e0, e1)`` one (each unordered pair of
  the half shell counted with its ordered multiplicity, the JAX
  package's ``_asym_weights``);
* the cross-group sweep (:func:`cross_pair_histogram`, kernel
  ``csrc/cross_pair_histogram.cu``): each group-1 home cell against the
  cells around it in group 2's table, every ordered (group-1, group-2)
  pair -- an atom in both groups meets itself at distance 0, in bin 0 --
  with an optional ``(e0, e1)`` tile exclusion;
* their triclinic twins (:func:`triclinic_cell_pair_histogram`,
  :func:`triclinic_cross_pair_histogram`, the triclinic entry points of
  the same two sources): the atoms are folded into the primary cell and
  gridded in fractional coordinates; on a reach-1 grid of at least 3
  cells per axis each (cell, neighbour) block takes one lattice
  translation from the frame's double-float image table
  (:func:`_image_shift_table`), on any other grid (``tri_pp``,
  :func:`plan_is_tri_pp`) each pair searches its 27 nearest images.

Grids come from :func:`cell_plan_search`.  A box at least 3 cutoffs
wide on every axis takes a reach-1 grid (cells at least ``r_max``
wide, the 14-entry half shell or the 27-entry full shell); a narrower
one takes a generalized grid: any cell count from 1 per axis, cells
narrower than ``r_max`` swept ``reach`` cells out on each axis, through
the deduped neighbour tables of :func:`_general_tables`.  An
orthorhombic grid may span two axes only (``n_cells_dim`` of 2 entries
and ``axes=``, the 2-D ``drop_axis`` RDF): each cell is then a whole
column along the dropped axis, and a pair's distance sums the two kept
components (:func:`_grid3`).

Sorted atom positions are packed into a padded ``(n_cells * capacity,
4)`` float32 slot table (xyz, then an id column: the atom index, or its
exclusion tile ``index // e``; an asymmetric self exclusion adds a
second tile id, ``index // e1``, in a side table of its own).  Every
kernel bins every pair through the same device functions
(``csrc/cell_bin.cuh``): exactly in double-float by default, against
uniform bins from 0 or (``r_min > 0``) from ``r_min`` with the closed
last edge of ``numpy.histogram``, or, with ``precision="fast"``, from
the float32 distance (:func:`_bin_boundary_constants`).

Each wrapper launches its kernel for tensors on a CUDA device and runs
its ``*_reference`` twin -- the same computation in plain torch, on the
same slot tables -- for tensors on the CPU.  There is no fallback
between the two: a CUDA tensor launches the kernel or raises, and so
does a plan that the kernel cannot launch.
"""

import itertools
import math
from functools import lru_cache

import numpy as np
import torch

from . import _build
from .doublefloat import (
    df_add,
    df_ge,
    df_lt,
    df_sub,
    df_sum3,
    df_square,
    f32_constant,
    two_diff,
    two_prod,
)
from .histogram import (
    _exact_d2_orthorhombic,
    _exact_d2_triclinic,
    _inv3,
    _row_times,
)

__all__ = [
    "CellCapacityOverflow",
    "cell_plan_search",
    "grid_plan",
    "plan_is_tri_pp",
    "cell_pair_histogram",
    "cell_pair_histogram_reference",
    "cross_pair_histogram",
    "cross_pair_histogram_reference",
    "triclinic_cell_pair_histogram",
    "triclinic_cell_pair_histogram_reference",
    "triclinic_cross_pair_histogram",
    "triclinic_cross_pair_histogram_reference",
    "triclinic_perpendicular_widths",
    "swept_pairs",
]

#: half-shell neighbor-table width: the home cell plus the 13
#: positive-lexicographic offsets.
N_HALF = 14

#: full-shell neighbor-table width: every offset in {-1, 0, 1}^3.
N_FULL = 27


def _offsets(d):
    """Every offset in {-1, 0, 1}^d, lexicographic (the full shell), and
    the home cell followed by the positive ones (the half shell)."""

    full = list(itertools.product((-1, 0, 1), repeat=d))
    return full, [(0,) * d] + [o for o in full if o > (0,) * d]


_FULL_OFFSETS, _HALF_OFFSETS = _offsets(3)

#: the 27 per-axis wrap counts ``w`` in {-1, 0, 1}^3, indexed by the
#: image row ``k = (wx+1)*9 + (wy+1)*3 + (wz+1)`` (13 is the zero image).
_IMAGE_COMBOS = np.array(_FULL_OFFSETS, dtype=np.float32)

#: float32 holds every integer id below 2^24 exactly.
_MAX_EXACT_ID = 1 << 24

#: capacity granule (one warp of slots).
_CAP_STEP = 32

#: shared memory one thread block of an H100 may opt in to (232,448
#: bytes): the brute pair histogram's tile and histogram must fit in it,
#: and the cell kernels' histogram copies beside their ring
#: (``csrc/cell_sweep.cuh``), or they count in global memory.
_SMEM_BYTES = 232_448

#: shared-memory bytes a slot takes: xyz and an id (a float4), and for
#: an asymmetric self exclusion a second id beside it.
_SLOT_BYTES = 16
_ASYM_SLOT_BYTES = 20

#: the planner's capacity ceiling for 16-byte slots, sized when a block
#: held two whole slot blocks in shared memory (4,096 slots take 128 KB
#: of it); :func:`_max_capacity` scales it for wider slots.  The cell
#: kernels now stream the slots and need no ceiling of their own beyond
#: exact float32 ids.
_MAX_CAPACITY = 4096

#: thread blocks a frame that fill the card: 132 SMs, each holding about
#: four 256-thread blocks at once.  A plan with fewer (cell, neighbour)
#: blocks a frame leaves SMs idle, so it is costed as if it had these.
_N_SMS = 132
_FILL_BLOCKS = 4 * _N_SMS


def _cdiv(a, b):
    return -(-a // b)


class CellCapacityOverflow(RuntimeError):
    """A frame's densest cell exceeded the planned slot capacity.

    The plan leaves ``capacity_sigmas`` Poisson sigmas of headroom
    above the mean occupancy; analyses catch this and retry with a
    larger ``capacity_sigmas``."""


def _capacity(n_atoms, n_cells, capacity_sigmas):
    """Per-cell slot capacity: ``mean + sigmas * sqrt(mean) + 4``
    rounded up to a multiple of 32, at least 32 and at most the whole
    group (rounded up)."""

    mean = n_atoms / n_cells
    cap = math.ceil(mean + capacity_sigmas * math.sqrt(mean) + 4)
    cap = _cdiv(cap, _CAP_STEP) * _CAP_STEP
    whole = _cdiv(max(n_atoms, 1), _CAP_STEP) * _CAP_STEP
    return max(_CAP_STEP, min(cap, whole))


def _max_capacity(slot_bytes=_SLOT_BYTES):
    """The planner's capacity ceiling for slots of `slot_bytes`:
    ``_MAX_CAPACITY`` for 16-byte slots, scaled down (to a multiple of
    32) so that two slot blocks of wider slots take no more shared
    memory: 3,264 slots of 20 bytes."""

    return _MAX_CAPACITY * _SLOT_BYTES // slot_bytes // _CAP_STEP * _CAP_STEP


def cell_plan_search(n_atoms, box, r_max, *, n_atoms2=None,
                     capacity_sigmas=4.0, slot_bytes=_SLOT_BYTES):
    """Cost-driven cell grid (host side): the ``n_cells_dim`` (and
    per-axis ``reach``) that minimizes the kernel's padded pair work.
    Depends only on its arguments, never on whether a card is present.

    ``box`` holds the extents the grid spans: the three box lengths of
    an orthorhombic box, or the perpendicular widths of a triclinic one
    (:func:`triclinic_perpendicular_widths`), or the two kept lengths of
    a 2-D grid (the ``drop_axis`` RDF; the plan's ``n_cells_dim`` and
    ``reach`` then have 2 entries).  Capacities follow :func:`_capacity`;
    a plan whose capacity exceeds the ceiling of :func:`_max_capacity`
    for slots of `slot_bytes` (4,096 slots of 16 bytes, from the H100's
    227 KB of shared memory a block; 20 bytes for an asymmetric self
    exclusion) is never chosen.

    * **Reach 1**, for a box at least 3 cutoffs wide on every axis:
      grids of ``3 <= n_i <= floor(L_i / r_max)`` cells, each at least
      ``r_max`` wide, costed ``n_cells * 14 * capacity**2`` for the
      self sweep or, with ``n_atoms2``, ``n_cells * 27 * capacity *
      capacity2`` for the cross sweep, whose two groups share one grid
      (ties to fewer cells; a 2-D grid sweeps 5 and 9 cells).  ``reach``
      is 1 on every axis.
    * **Generalized** (the JAX package's generalized space), for a box
      under 3 cutoffs on some axis, or one whose every reach-1 plan is
      over the capacity ceiling: any grid from 1 cell per axis up to
      ``max(3, floor(L_i / r_max), n_target)``, ``n_target =
      ceil((N / 64)^(1/d)) + 1`` for ``d`` axes (about 64 atoms a cell;
      a geometric subset of the counts above 16 on an axis), each axis
      swept
      ``reach_i = floor(r_max * n_i / L_i + 1e-9) + 1`` cells out.  An
      axis with ``n_i <= 2 reach_i + 1`` is swept whole, so a cell has
      ``n_full = prod(min(n_i, 2 reach_i + 1))`` distinct neighbours;
      the self sweep visits ``n_eff = (n_full - 1) // 2 + 1`` of them
      (half shell) when every ``n_i >= 2 reach_i + 1`` and all
      ``n_full`` (ordered) otherwise, the cross sweep all ``n_full``.
      The cost is ``max(blocks, 528) * capacity * capacity2`` with
      ``blocks = n_cells * n_eff`` thread blocks a frame: the padded
      pair work of a block, and a frame of fewer than 528 blocks
      (``_FILL_BLOCKS``, about four on each of the H100's 132 SMs)
      costed as if it had that many, since it leaves SMs idle.  Without
      the ceiling and the fill term the search would put a small group
      into one cell: one block a frame, and a slot block too large for
      shared memory.  Padding each capacity to the 32-slot granule
      makes grids much finer than a few atoms a cell cost more.

    Returns ``{"n_cells_dim", "n_cells", "capacity", "reach",
    "_cost"}``, plus ``"capacity2"`` (group 2's slots) for a cross
    plan.  Raises `ValueError` when no grid has a launchable capacity.
    """

    box = np.asarray(box, dtype=float)
    if box.shape not in ((2,), (3,)):
        raise ValueError("cell_plan_search takes 2 or 3 box extents.")
    max_cap = _max_capacity(slot_bytes)
    floors = np.floor(box / r_max).astype(int)
    if np.all(floors >= 3):
        plan = _reach1_plan(n_atoms, floors, n_atoms2, capacity_sigmas,
                            max_cap)
        if plan is not None:
            return plan
    return _general_plan(n_atoms, box, r_max, floors, n_atoms2,
                         capacity_sigmas, max_cap)


def _reach1_plan(n_atoms, floors, n_atoms2, capacity_sigmas, max_cap):
    """The cheapest reach-1 plan within the capacity ceiling, or None."""

    # Every legal grid, in order.  The cost depends on a grid only
    # through its cell-count product and ties keep the first grid, so
    # a product seen before cannot win and is skipped.
    full, half = _offsets(len(floors))
    best = None
    seen = set()
    for dims in itertools.product(*[range(3, int(m) + 1) for m in floors]):
        n_cells = int(np.prod(dims))
        if n_cells in seen:
            continue
        seen.add(n_cells)
        cap = _capacity(n_atoms, n_cells, capacity_sigmas)
        plan = {
            "n_cells_dim": dims,
            "n_cells": n_cells,
            "capacity": cap,
            "reach": (1,) * len(dims),
        }
        if n_atoms2 is None:
            cost = n_cells * len(half) * cap * cap
        else:
            plan["capacity2"] = _capacity(n_atoms2, n_cells,
                                          capacity_sigmas)
            cost = n_cells * len(full) * cap * plan["capacity2"]
        if max(cap, plan.get("capacity2", 0)) > max_cap:
            continue
        plan["_cost"] = cost
        key = (cost, n_cells)
        if best is None or key < best[0]:
            best = (key, plan)
    return None if best is None else best[1]


def _axis_candidates(m):
    """Cell counts an axis of a generalized grid may take: every count
    from 1 to ``m`` up to 16, else a geometric subset (steps of about
    8 %, both ends kept), as in the JAX package's search."""

    m = int(m)
    if m <= 16:
        return list(range(1, m + 1))
    vals = {1, m}
    v = 1.0
    while v < m:
        vals.add(int(round(v)))
        v *= 1.08
    return sorted(vals)


def grid_plan(n_atoms, box, r_max, n_cells_dim, *, n_atoms2=None,
              capacity_sigmas=4.0):
    """The generalized plan of one given grid (a plan chosen by hand, as
    the checks that must not depend on the search use): the capacities
    of :func:`_capacity` and the per-axis reach ``floor(r_max * n_i /
    L_i + 1e-9) + 1`` over the extents ``box``.  Returns the keys of
    :func:`cell_plan_search` but ``"_cost"``."""

    dims = tuple(int(n) for n in n_cells_dim)
    n_cells = int(np.prod(dims))
    plan = {
        "n_cells_dim": dims,
        "n_cells": n_cells,
        "capacity": _capacity(n_atoms, n_cells, capacity_sigmas),
        "reach": tuple(
            int(np.floor(r_max * n / w + 1e-9)) + 1
            for n, w in zip(dims, np.asarray(box, dtype=float))
        ),
    }
    if n_atoms2 is not None:
        plan["capacity2"] = _capacity(n_atoms2, n_cells, capacity_sigmas)
    return plan


def _general_plan(n_atoms, box, r_max, floors, n_atoms2, capacity_sigmas,
                  max_cap):
    """The cheapest generalized plan (see :func:`cell_plan_search`)."""

    cross = n_atoms2 is not None
    n_target = int(
        np.ceil((max(n_atoms, n_atoms2 or 0) / 64.0) ** (1.0 / len(box)))
    ) + 1
    max_dims = np.maximum(3, np.maximum(floors, n_target))
    best = None
    for dims in itertools.product(*[_axis_candidates(m) for m in max_dims]):
        plan = grid_plan(n_atoms, box, r_max, dims, n_atoms2=n_atoms2,
                         capacity_sigmas=capacity_sigmas)
        cap1 = plan["capacity"]
        cap2 = plan.get("capacity2", cap1)
        if max(cap1, cap2) > max_cap:
            continue
        n_full = 1
        for n, m in zip(dims, plan["reach"]):
            n_full *= min(n, 2 * m + 1)
        half_ok = all(n >= 2 * m + 1 for n, m in zip(dims, plan["reach"]))
        if cross or not half_ok:
            n_eff = n_full
        else:
            n_eff = (n_full - 1) // 2 + 1
        blocks = plan["n_cells"] * n_eff
        plan["_cost"] = max(blocks, _FILL_BLOCKS) * cap1 * cap2
        key = (plan["_cost"], plan["n_cells"])
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(
            f"No cell grid of at most {max_cap} slots a cell for "
            f"{n_atoms} atoms (box {box.tolist()}, r_max {r_max})."
        )
    return best[1]


def plan_is_tri_pp(plan, triclinic):
    """Does this plan run the per-pair 27-candidate triclinic sweep?
    True for a triclinic box on any grid but a reach-1 grid of at least
    3 cells per axis (there, each (cell, neighbour) block takes one
    lattice translation).  The one definition of the route: the
    triclinic wrappers and the analyses both call it."""

    return bool(triclinic) and _generalized(plan["n_cells_dim"],
                                            plan["reach"])


def _generalized(n_cells_dim, reach):
    """Is this grid off the reach-1, 3-cells-per-axis route?"""

    return (any(int(m) != 1 for m in reach)
            or any(int(n) < 3 for n in n_cells_dim))


def _bin_boundary_constants(r_max, n_bins, r_min=0.0):
    """Binning constants of uniform bins on ``[r_min, r_max]``, a tuple
    whose first entry names the convention, as the JAX package's
    function:

    * ``("zero", inv_dr, dr2_hi, dr2_lo)`` -- bins from 0:
      ``r_max / n_bins`` rounded in float64 first, then squared and
      split into a double-float pair (matches the XLA sweep's edge
      width);
    * ``("offset", e0, inv_h, c0, c1, c2)`` -- bins from ``r_min > 0``:
      the boundary ``(e0 + k h)^2 = e0^2 + 2 e0 h k + h^2 k^2`` with
      each coefficient ``(hi, lo)`` split from float64 endpoints (an
      ``e0`` rounded to float32 first would move every boundary and
      flip bin-edge tie pairs), the float32 ``e0`` and ``1 / h`` of the
      index estimate; the convention of ``ops/histogram._exact_bin_indices``
      (closed last edge, below-range spill).

    Plain floats (numpy float32), shared by the kernels and their plain
    versions."""

    if r_min == 0.0:
        inv_dr = np.float32(np.float64(n_bins) / np.float64(r_max))
        dr2_wide = (np.float64(r_max) / np.float64(n_bins)) ** 2
        dr2_hi = np.float32(dr2_wide)
        dr2_lo = np.float32(dr2_wide - np.float64(dr2_hi))
        return ("zero", inv_dr, dr2_hi, dr2_lo)
    e0 = np.float64(r_min)
    h = (np.float64(r_max) - e0) / np.float64(n_bins)

    def split(x):
        hi = np.float32(x)
        return (hi, np.float32(x - np.float64(hi)))

    return ("offset", np.float32(e0), np.float32(1.0 / h), split(e0 * e0),
            split(2.0 * e0 * h), split(h * h))


def _launch_constants(consts):
    """A convention's constants as the kernels' entry points take them:
    the offset flag and 8 floats (``inv_dr, dr2_hi, dr2_lo`` and zeros,
    or ``e0, inv_h`` and the three coefficients' ``(hi, lo)``)."""

    if consts[0] == "zero":
        return (0, *consts[1:], *(np.float32(0.0),) * 5)
    _, e0, inv_h, c0, c1, c2 = consts
    return (1, e0, inv_h, *c0, *c1, *c2)


def _device_constants(consts, device):
    """The constants as 0-d float32 tensors on `device` (a constant that
    enters a Dekker split must not be a Python float)."""

    if consts[0] == "zero":
        return ("zero", *(f32_constant(c, device) for c in consts[1:]))
    _, e0, inv_h, *coefficients = consts
    return ("offset", f32_constant(e0, device), f32_constant(inv_h, device),
            *(tuple(f32_constant(x, device) for x in c)
              for c in coefficients))


def _grid(n_cells_dim):
    dims = tuple(int(n) for n in n_cells_dim)
    return dims, np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")


def _reach1_grid(n_cells_dim):
    """The grid of a reach-1 table: at least 3 cells per axis, so the
    27 offsets in {-1, 0, 1}^3 wrap onto distinct cells."""

    dims = tuple(int(n) for n in n_cells_dim)
    if any(n < 3 for n in dims):
        raise ValueError(
            "The reach-1 neighbor tables need >= 3 cells per axis "
            "(other grids take _general_tables)."
        )
    return dims


def _neighbor_table(n_cells_dim, offsets):
    """``(n_cells, len(offsets))`` int32 table of each cell's wrapped
    neighbours at the given offsets."""

    dims, grids = _grid(n_cells_dim)
    cols = []
    for o in offsets:
        c = np.zeros(dims, dtype=np.int64)
        for ax in range(3):
            stride = int(np.prod(dims[ax + 1:]))
            c = c + ((grids[ax] + o[ax]) % dims[ax]) * stride
        cols.append(c.reshape(-1))
    return np.stack(cols, axis=-1).astype(np.int32)


def _image_table(n_cells_dim, offsets):
    """``(n_cells, len(offsets))`` int32 image rows aligned with
    :func:`_neighbor_table`: ``k = (wx+1)*9 + (wy+1)*3 + (wz+1)`` with
    ``w`` the per-axis wrap count ``floor((cell + offset) / n)`` in
    {-1, 0, 1} -- the row of :func:`_image_shift_table` that moves the
    neighbour's atoms next to the home cell (the JAX package's
    ``full_img`` and ``half_img``)."""

    dims, grids = _grid(n_cells_dim)
    cols = []
    for o in offsets:
        k = np.zeros(dims, dtype=np.int64)
        for ax in range(3):
            k = k * 3 + (grids[ax] + o[ax]) // dims[ax] + 1
        cols.append(k.reshape(-1))
    return np.stack(cols, axis=-1).astype(np.int32)


@lru_cache(maxsize=None)
def _half_table(n_cells_dim):
    """``(n_cells, 14)`` int32 half-shell table: the home cell, then the
    13 positive-lexicographic offsets in {-1, 0, 1}^3, wrapped.  With
    at least 3 cells per axis every unordered cell pair appears once."""

    return _neighbor_table(_reach1_grid(n_cells_dim), _HALF_OFFSETS)


@lru_cache(maxsize=None)
def _full_table(n_cells_dim):
    """``(n_cells, 27)`` int32 full-shell table: every offset in
    {-1, 0, 1}^3, wrapped (the full table of the JAX package's
    ``_neighbor_tables``).  With at least 3 cells per axis the 27
    neighbours of a cell are distinct, so every ordered cell pair within
    reach appears once."""

    return _neighbor_table(_reach1_grid(n_cells_dim), _FULL_OFFSETS)


@lru_cache(maxsize=None)
def _half_images(n_cells_dim):
    """Image rows of :func:`_half_table`'s entries."""

    return _image_table(_reach1_grid(n_cells_dim), _HALF_OFFSETS)


@lru_cache(maxsize=None)
def _full_images(n_cells_dim):
    """Image rows of :func:`_full_table`'s entries."""

    return _image_table(_reach1_grid(n_cells_dim), _FULL_OFFSETS)


@lru_cache(maxsize=None)
def _general_tables(n_cells_dim, reach):
    """Deduped neighbour tables of a 3-D grid with per-axis reach ``m_i``
    (offsets in ``[-m_i, m_i]``), row for row and column for column the
    JAX package's ``_neighbor_tables_general``.  Returns ``(full,
    half)``:

    * ``full`` -- ``(n_cells, n_full)`` int32: every DISTINCT wrapped
      neighbour of each home cell within the reach block, the home cell
      in column 0.  An axis with ``n_i <= 2 m_i + 1`` contributes each
      of its cells once, starting at the home coordinate (the wrap
      would otherwise alias offsets), so every ordered cell pair within
      reach appears once and per-pair minimum images count every ordered
      atom pair once (the ordered and cross sweeps);
    * ``half`` -- ``(n_cells, n_half)`` int32, the home cell and then
      the positive-lexicographic offsets (each unordered cell pair
      once: the half-shell sweep), or None when some axis has ``n_i <
      2 m_i + 1`` (wrapped offsets then collide)."""

    dims, grids = _grid(n_cells_dim)
    reach = tuple(int(m) for m in reach)
    strides = (dims[1] * dims[2], dims[2], 1)
    n_cells = dims[0] * dims[1] * dims[2]
    cid = 0
    for ax, (n, m) in enumerate(zip(dims, reach)):
        if n <= 2 * m + 1:
            offs = np.arange(n)
        else:
            offs = np.concatenate(([0], np.arange(-m, 0), np.arange(1, m + 1)))
        coords = ((np.arange(n)[:, None] + offs[None, :]) % n)[grids[ax]]
        shape = [*dims, 1, 1, 1]
        shape[3 + ax] = len(offs)
        cid = cid + coords.reshape(shape) * strides[ax]
    full = cid.reshape(n_cells, -1).astype(np.int32)
    if any(n < 2 * m + 1 for n, m in zip(dims, reach)):
        return full, None
    offsets = itertools.product(*[range(-m, m + 1) for m in reach])
    half = [(0, 0, 0)] + [o for o in offsets if o > (0, 0, 0)]
    return full, _neighbor_table(dims, half)


def _image_shift_table(box):
    """Each frame's 27 lattice translations ``w @ H`` (``w`` the rows of
    ``_IMAGE_COMBOS``) as double-floats: ``(hi, lo)``, each ``(B, 27,
    3)`` float32, for float32 box matrices ``box`` ``(B, 3, 3)``.

    Column ``k`` accumulates the diagonal term first, then the rows
    below (the matrix is lower-triangular), one double-float op at a
    time -- the order of the JAX package's ``_image_shift_table`` and
    of the 27-image sweep ``ops/histogram._exact_d2_triclinic``, so a
    pair's d^2 splits the same way in the kernels and in that sweep
    (double-float compares are split-sensitive on bin-edge ties)."""

    combos = torch.as_tensor(_IMAGE_COMBOS, device=box.device)
    hi, lo = [], []
    for col in range(3):
        t = two_prod(combos[:, col], box[:, col, col, None])
        for row in range(col + 1, 3):
            t = df_add(t, two_prod(combos[:, row], box[:, row, col, None]))
        hi.append(t[0])
        lo.append(t[1])
    return (torch.stack(hi, dim=-1).contiguous(),
            torch.stack(lo, dim=-1).contiguous())


def triclinic_perpendicular_widths(box_matrix):
    """Perpendicular widths ``V / |row_j x row_k|`` of lower-triangular
    box matrices ``(..., 3, 3)`` -- the distance between the periodic
    faces along each lattice direction, operation for operation as the
    JAX package's function.  A triclinic grid is legal when ``n_i <=
    floor(w_i / r_max)``.  NumPy in, NumPy out; torch in, torch out."""

    h = box_matrix
    xp = torch if isinstance(h, torch.Tensor) else np
    volume = xp.abs(h[..., 0, 0] * h[..., 1, 1] * h[..., 2, 2])

    def cross_norm(u, v):
        c0 = u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]
        c1 = u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2]
        c2 = u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]
        return xp.sqrt(c0 * c0 + c1 * c1 + c2 * c2)

    rows = [h[..., i, :] for i in range(3)]
    norms = xp.stack(
        [cross_norm(rows[1], rows[2]), cross_norm(rows[0], rows[2]),
         cross_norm(rows[0], rows[1])],
        axis=-1,
    )
    return volume[..., None] / norms


def _cell_sweep_ok(extents, n_cells_dim, reach, r_max):
    """``(B,)`` bool: is the sweep of reach ``m_i`` complete for each
    frame's extents (orthorhombic box lengths, or the perpendicular
    widths of a tri_pp grid)?  Cells at offset ``m_i + 1`` (the first
    ring left out) are at least ``m_i * extents_i / n_i`` apart along
    axis ``i``, so the sweep is complete when that is at least
    ``r_max``, except along axes of at most ``2 m_i + 1`` cells, which
    the sweep spans whole (the JAX package's ``_cell_sweep_ok``; with
    ``reach == (1, 1, 1)``, cells at least ``r_max`` wide or 3 cells)."""

    dims = torch.tensor(n_cells_dim, dtype=torch.float32,
                        device=extents.device)
    mr = torch.tensor(reach, dtype=torch.float32, device=extents.device)
    whole_axis = torch.tensor(
        [n <= 2 * m + 1 for n, m in zip(n_cells_dim, reach)],
        device=extents.device,
    )
    # Python floats of float32 values: weak scalars, float32 products.
    wide_enough = (
        extents * mr * float(np.float32(1 + 1e-6))
        >= dims * float(np.float32(r_max))
    )
    return (wide_enough | whole_axis).all(dim=-1)


def _triclinic_sweep_ok(box, n_cells_dim, r_max):
    """``(B,)`` bool: is every cell of each frame's triclinic grid at
    least ``r_max`` wide along every lattice direction?  Strict: a
    block's one lattice translation is the minimum image only then, so
    unlike :func:`_cell_sweep_ok` there is no 3-cell exception.  A zero
    (padding) box has NaN widths and fails."""

    dims = torch.tensor(n_cells_dim, dtype=torch.float32, device=box.device)
    widths = triclinic_perpendicular_widths(box)
    return (
        widths * float(np.float32(1 + 1e-6))
        >= dims * float(np.float32(r_max))
    ).all(dim=-1)


def _triclinic_wrap_cells(positions, box, n_cells_dim):
    """Fold ``(B, N, 3)`` positions into each frame's primary triclinic
    cell and assign cells in fractional coordinates; returns ``(wrapped,
    cell_xyz)``.  ``frac = p @ inv(H)`` and the fold ``p - floor(frac) @
    H`` are written out elementwise in a fixed order, so the fold is the
    identity (bit for bit) for positions already inside the cell away
    from its faces, and the same on the card and on the CPU."""

    frac = _row_times(positions, _inv3(box)[:, None])
    m = torch.floor(frac)
    wrapped = positions - _row_times(m, box[:, None])
    hi = torch.tensor([n - 1 for n in n_cells_dim], dtype=torch.int32,
                      device=positions.device)
    dims = torch.tensor(n_cells_dim, dtype=torch.float32,
                        device=positions.device)
    cell_xyz = ((frac - m) * dims).to(torch.int32)
    return wrapped, torch.minimum(torch.clamp(cell_xyz, min=0), hi)


def _slot_table(positions, n_cells_dim, capacity, cell_size, ex=None,
                cell_xyz=None, ex_j=None, id_offset=0):
    """Batched cell build: cell ids, a stable ``argsort``,
    ``searchsorted`` cell starts and a padded gather.

    ``positions`` ``(B, N, 3)`` float32, ``cell_size`` ``(B, 3)``
    float32, or ``cell_xyz`` ``(B, N, 3)`` int32 cell coordinates in
    its place (the triclinic fractional build).  Returns the ``(B,
    n_cells * capacity, 4)`` slot table (xyz, then the id ``index //
    ex`` as float32 -- the atom index when ``ex`` is None; slots past a
    cell's occupancy hold neighbouring atoms, which the kernels mask),
    the ``(B, n_cells)`` int32 occupancy and the ``(B,)`` maximum
    occupancy.  With ``ex_j`` the table has a fifth column, the second
    tile id ``index // ex_j`` of an asymmetric exclusion (the kernel
    takes it as a side table of its own).  With `id_offset` the ids are
    those of ``index + id_offset``: a block of a larger group (a shard of
    the atom-sharded ring) keeps the group's exclusion tiles."""

    nx, ny, nz = n_cells_dim
    n_cells = nx * ny * nz
    b, n, _ = positions.shape
    device = positions.device
    if cell_xyz is None:
        hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int32,
                          device=device)
        cell_xyz = (positions / cell_size[:, None, :]).to(torch.int32)
        cell_xyz = torch.minimum(torch.clamp(cell_xyz, min=0), hi)
    cid = (cell_xyz[..., 0] * ny + cell_xyz[..., 1]) * nz + cell_xyz[..., 2]
    order = torch.argsort(cid, dim=1, stable=True)
    sorted_cid = torch.gather(cid, 1, order).contiguous()
    cells = torch.arange(n_cells, dtype=torch.int32, device=device)
    cells = cells.expand(b, n_cells).contiguous()
    starts = torch.searchsorted(sorted_cid, cells, side="left")
    ends = torch.searchsorted(sorted_cid, cells, side="right")
    occupancy = (ends - starts).to(torch.int32)

    atom = torch.arange(id_offset, id_offset + n, device=device)
    columns = [positions]
    for e in (ex, ex_j) if ex_j is not None else (ex,):
        ids = atom if e is None else atom // int(e)
        columns.append(ids.to(torch.float32).expand(b, n)[..., None])
    packed = torch.cat(columns, dim=-1)
    width = packed.shape[-1]
    packed = torch.gather(packed, 1, order[..., None].expand(b, n, width))
    slots = torch.arange(capacity, device=device)
    index = torch.clamp(starts[:, :, None] + slots, max=n - 1)
    index = index.reshape(b, n_cells * capacity)
    table = torch.gather(packed, 1, index[..., None].expand(-1, -1, width))
    return table.contiguous(), occupancy, occupancy.amax(dim=1)


def _tables(positions, box, dims, capacity, ex=None, ex_j=None,
            id_offset=0):
    """Slot table, occupancy and maximum occupancy of one group: cells
    of ``box / dims`` for orthorhombic ``(B, 3)`` boxes, the fractional
    fold and grid of :func:`_triclinic_wrap_cells` for ``(B, 3, 3)``
    box matrices.  A kernel and its plain version both take their slot
    tables from here, so they bin the same float32 coordinates and agree
    as integers whatever the cell assignment.  `id_offset` as
    :func:`_slot_table`'s."""

    if box.ndim == 3:
        wrapped, cell_xyz = _triclinic_wrap_cells(positions, box, dims)
        return _slot_table(wrapped, dims, capacity, None, ex=ex,
                           cell_xyz=cell_xyz, ex_j=ex_j,
                           id_offset=id_offset)
    cell_size = box / torch.tensor(dims, dtype=torch.float32,
                                   device=box.device)
    return _slot_table(positions, dims, capacity, cell_size, ex=ex,
                       ex_j=ex_j, id_offset=id_offset)


def _bin_index(d2, consts, n_bins):
    """Exact bin index from a double-float ``d2`` under the constants of
    :func:`_device_constants` (``_exact_index_from_d2``, either
    convention); ``n_bins`` or above means out of range."""

    if consts[0] == "offset":
        return _offset_bin_index(d2, consts, n_bins)
    _, inv_dr, dr2_hi, dr2_lo = consts
    est = torch.sqrt(torch.clamp(d2[0], min=0.0)) * inv_dr
    # Clamp before the truncating cast: far pairs of huge boxes stay in
    # int32 range, and trunc(min(x, n)) == min(trunc(x), n) for x >= 0.
    idx = torch.clamp(est, max=float(n_bins)).to(torch.int32)
    zero = torch.zeros_like(d2[0])

    def boundary(k):
        k2 = (k * k).to(torch.float32)
        bh, bl = two_prod(k2, dr2_hi)
        return df_add((zero, zero), (bh, bl + k2 * dr2_lo))

    return (
        idx
        + df_ge(d2, boundary(idx + 1)).to(torch.int32)
        - df_lt(d2, boundary(idx)).to(torch.int32)
    )


def _offset_bin_index(d2, consts, n_bins):
    """The ``"offset"`` tail of ``_exact_index_from_d2``, operation for
    operation: boundaries ``df_add(df_add(c0, t1), t2)``, an estimate
    from ``(dist - e0) * inv_h`` clipped to ``[0, n_bins]`` before the
    +-1 correction, the below-range spill, the closed last edge (a pair
    exactly on it, both halves equal, lands in the last bin) and
    ``min(idx, n_bins - 1)`` in range."""

    _, e0, inv_h, c0, c1, c2 = consts

    def boundary(k):
        kf = k.to(torch.float32)
        k2 = kf * kf
        t1 = two_prod(kf, c1[0])
        t2 = two_prod(k2, c2[0])
        acc = df_add(c0, (t1[0], t1[1] + kf * c1[1]))
        return df_add(acc, (t2[0], t2[1] + k2 * c2[1]))

    dist = torch.sqrt(torch.clamp(d2[0], min=0.0))
    # Clamped before the truncating cast, which then equals the JAX
    # package's clip after it.
    est = torch.clamp((dist - e0) * inv_h, 0.0, float(n_bins))
    idx = est.to(torch.int32)
    idx = (
        idx
        + df_ge(d2, boundary(idx + 1)).to(torch.int32)
        - df_lt(d2, boundary(idx)).to(torch.int32)
    )
    b_last = boundary(torch.full_like(idx, n_bins))
    b_first = boundary(torch.zeros_like(idx))
    at_last = (d2[0] == b_last[0]) & (d2[1] == b_last[1])
    in_range = df_ge(d2, b_first) & (df_lt(d2, b_last) | at_last)
    return torch.where(in_range, torch.clamp(idx, max=n_bins - 1), n_bins)


def _fast_bin_index(d2, consts, n_bins):
    """Fast-path bin index from a float32 ``d2`` (``_fast_index_from_dist``
    of its square root, either convention); ``n_bins`` or above means
    out of range.  Clamped to ``n_bins`` before the truncating cast,
    which changes no index below it.  The root is taken in float64 and
    rounded to float32: correctly rounded, as numpy's, XLA's and CUDA's
    ``sqrtf`` are (torch's float32 ``sqrt`` on the CPU is not always)."""

    dist = torch.sqrt(d2.double()).float()
    if consts[0] == "zero":
        return torch.clamp(dist * consts[1], max=float(n_bins)).to(
            torch.int32)
    _, e0, inv_h = consts[:3]
    idx = torch.clamp((dist - e0) * inv_h, 0.0, float(n_bins)).to(
        torch.int32)
    # Truncation rounds (-1, 0) up to 0: spill below-range distances.
    return torch.where(dist < e0, n_bins, idx)


def _fast_d2_orthorhombic(p1, p2, box, n_axes=3):
    """float32 squared minimum-image distance (the JAX package's
    ``_bin_fast``): each component ``delta - L * round(delta / L)``,
    squares summed left to right over the first `n_axes` axes."""

    d2 = None
    for k in range(n_axes):
        delta = p1[..., k] - p2[..., k]
        delta = delta - box[k] * torch.round(delta / box[k])
        d2 = delta * delta if d2 is None else d2 + delta * delta
    return d2


def _fast_d2_shifted(p1, p2, shift_hi):
    """float32 squared distance under a block's lattice translation
    (``_bin_fast_shift``): ``(p1 - shift_hi) - p2`` on each axis."""

    d2 = None
    for k in range(3):
        delta = (p1[..., k] - shift_hi[..., k]) - p2[..., k]
        d2 = delta * delta if d2 is None else d2 + delta * delta
    return d2


def _fast_d2_triclinic(p1, p2, box, inv):
    """float32 squared triclinic minimum-image distance
    (``_bin_fast_tri27``): the fractional displacement folded by
    ``round``, back to Cartesian, then the smallest of it and its 26
    neighbouring images, every product and sum in the JAX kernel's
    order.  ``box`` is the float32 lower-triangular box matrix, ``inv``
    its float32 inverse."""

    delta = [p1[..., k] - p2[..., k] for k in range(3)]
    frac = []
    for k in range(3):
        f = delta[0] * inv[0, k]
        f = f + delta[1] * inv[1, k]
        f = f + delta[2] * inv[2, k]
        frac.append(f - torch.round(f))
    base = []
    for k in range(3):
        b = frac[k] * box[k, k]
        for j in range(k + 1, 3):
            b = b + frac[j] * box[j, k]
        base.append(b)
    d2 = base[0] * base[0] + base[1] * base[1]
    d2 = d2 + base[2] * base[2]
    for shift in _FULL_OFFSETS:
        if shift == (0, 0, 0):
            continue
        cand2 = None
        for k in range(3):
            sv = float(shift[k]) * box[k, k]
            for j in range(k + 1, 3):
                sv = sv + float(shift[j]) * box[j, k]
            c = base[k] + sv
            cand2 = c * c if cand2 is None else cand2 + c * c
        d2 = torch.minimum(d2, cand2)
    return d2


def _shifted_d2(p1, p2, shift_hi, shift_lo):
    """d^2 of ``(p1 - p2) - shift`` in double-float, the pair difference
    error-free and the shift a double-float lattice translation (the
    kernels' ``ShiftImage``, the JAX package's ``_bin_exact_shift``)."""

    components = []
    for k in range(3):
        s, e = two_diff(p1[..., k], p2[..., k])
        d = df_sub((s, e), (shift_hi[..., k], shift_lo[..., k]))
        components.append(df_square(d))
    return df_sum3(*components)


def _sweep_reference(table1, occupancy1, capacity1, table2, occupancy2,
                     capacity2, nbr, box, r_max, n_bins, *, home_mask,
                     exclude, images=None, shifts=None, inverse=None,
                     r_min=0.0, precision="exact", n_axes=3, asym=False):
    """The kernels' sweep in plain torch: every home cell of slot table
    1 against its neighbour row ``nbr`` in slot table 2, the kernels'
    masks (occupied slots; in the home block (entry 0), ``home_mask``
    ``"triangle"`` keeps the strict upper slot triangle, ``"ids"``
    drops equal atom ids and ``"diagonal"`` equal slots; ``exclude``:
    drop pairs whose i-side id (column 3 of table 1) equals the j-side
    id (column 3 of table 2, or with ``asym`` its column 4); ``asym``
    without ``exclude``: count each kept pair ``[a3 != c4] + [c3 !=
    a4]`` times, the ordered multiplicity of an asymmetric tile on the
    half shell), the bins of the pairs kept -- per-pair orthorhombic
    minimum images in ``box`` ``(B, 3)`` over its first ``n_axes`` axes;
    with ``images`` (the neighbour rows' image table) and ``shifts``
    (:func:`_image_shift_table`), each block's lattice translation; with
    ``inverse`` (``(B, 3, 3)``, the inverses of the box matrices
    ``box``), the per-pair 27-candidate search (tri_pp) -- on bins from
    ``r_min``, exact or (``precision="fast"``) from the float32
    distance.  int64 ``(B, n_bins)``."""

    b = table1.shape[0]
    device = table1.device
    n_cells, n_nbr = nbr.shape
    consts = _device_constants(_bin_boundary_constants(r_max, n_bins, r_min),
                               device)
    exact = precision == "exact"
    weights = asym and not exclude
    j_id = 4 if asym else 3
    slots1 = torch.arange(capacity1, device=device)
    slots2 = torch.arange(capacity2, device=device)
    upper = slots1[:, None] < slots2[None, :]
    # home cells per step: bounds each (cells, cap1, cap2) temporary (a
    # quarter as many for the 27-candidate search's temporaries)
    pairs = (1 << 22) if inverse is None else (1 << 20)
    chunk = max(1, pairs // (capacity1 * capacity2))
    counts = torch.zeros((b, n_bins + 1), dtype=torch.int64, device=device)
    blocks1 = table1.reshape(b, n_cells, capacity1, table1.shape[-1])
    blocks2 = table2.reshape(b, n_cells, capacity2, table2.shape[-1])
    for f in range(b):
        occ1 = torch.clamp(occupancy1[f], max=capacity1)
        occ2 = torch.clamp(occupancy2[f], max=capacity2)
        for c0 in range(0, n_cells, chunk):
            home = torch.arange(c0, min(c0 + chunk, n_cells), device=device)
            ip = blocks1[f, home]
            i_valid = slots1[None, :] < occ1[home][:, None]
            for entry in range(n_nbr):
                other = nbr[home, entry]
                jp = blocks2[f, other]
                j_valid = slots2[None, :] < occ2[other][:, None]
                valid = i_valid[:, :, None] & j_valid[:, None, :]
                if entry == 0 and home_mask == "triangle":
                    valid = valid & upper
                if entry == 0 and home_mask == "diagonal":
                    valid = valid & (slots1[:, None] != slots2[None, :])
                if entry == 0 and home_mask == "ids":
                    valid = valid & (ip[:, :, None, 3] != jp[:, None, :, 3])
                if exclude:
                    valid = valid & (ip[:, :, None, 3]
                                     != jp[:, None, :, j_id])
                if weights:
                    w = ((ip[:, :, None, 3] != jp[:, None, :, 4]).int()
                         + (jp[:, None, :, 3] != ip[:, :, None, 4]).int())
                    valid = valid & (w > 0)
                # Bin the kept slot pairs only, as the kernels do.
                cell, i, j = valid.nonzero(as_tuple=True)
                a, c = ip[cell, i, :3], jp[cell, j, :3]
                if images is not None:
                    img = images[home, entry][cell]
                    if exact:
                        d2 = _shifted_d2(a, c, shifts[0][f, img],
                                         shifts[1][f, img])
                    else:
                        d2 = _fast_d2_shifted(a, c, shifts[0][f, img])
                elif inverse is not None:
                    d2 = (_exact_d2_triclinic(a, c, box[f], inverse[f])
                          if exact else
                          _fast_d2_triclinic(a, c, box[f], inverse[f]))
                else:
                    d2 = (_exact_d2_orthorhombic(a, c, box[f], n_axes)
                          if exact else
                          _fast_d2_orthorhombic(a, c, box[f], n_axes))
                idx = (_bin_index(d2, consts, n_bins) if exact
                       else _fast_bin_index(d2, consts, n_bins))
                idx = torch.clamp(idx, max=n_bins).long()
                counts[f] += torch.bincount(idx, minlength=n_bins + 1)
                if weights:
                    # a pair of multiplicity 2 counts once more
                    twice = w[cell, i, j] == 2
                    counts[f] += torch.bincount(idx[twice],
                                                minlength=n_bins + 1)
    return counts[:, :n_bins]


def _grid3(n_cells_dim, reach=None, axes=None, triclinic=False):
    """The 3-D grid a kernel sweeps for a plan's ``n_cells_dim`` and
    ``reach`` over the coordinate columns ``axes`` (default ``(0, 1,
    2)``; a 2-D grid must name its two), and the coordinate order the
    slot tables hold -- the grid's axes first -- or None for xyz.

    A 2-D grid ``(n0, n1)`` of reach ``(m0, m1)`` becomes ``(n0, n1,
    1)`` of reach ``(m0, m1, 0)``: each cell a whole column along the
    dropped axis, which the sweep spans whole.  Its deduped tables are
    then the JAX package's 2-D ``_neighbor_tables_general`` tables entry
    for entry, the reach test passes that axis, and the kernels sum the
    first two distance components only."""

    dims = tuple(int(n) for n in n_cells_dim)
    if len(dims) not in (2, 3):
        raise ValueError("n_cells_dim must have 2 or 3 entries.")
    axes = (0, 1, 2) if axes is None else tuple(int(a) for a in axes)
    if (len(axes) != len(dims) or len(set(axes)) != len(axes)
            or not set(axes) <= {0, 1, 2}):
        raise ValueError(
            "axes must name one distinct coordinate column per grid axis "
            "(a 2-D grid needs an explicit axes=)."
        )
    if triclinic and axes != (0, 1, 2):
        raise ValueError("A triclinic sweep spans all three axes (2-D "
                         "grids need an orthorhombic box).")
    reach = (1,) * len(dims) if reach is None else tuple(
        int(m) for m in reach)
    if len(reach) != len(dims) or min(reach) < 1:
        raise ValueError("reach must hold one positive cell count per grid "
                         "axis.")
    order = axes + tuple(a for a in range(3) if a not in axes)
    if len(dims) == 2:
        dims, reach = dims + (1,), reach + (0,)
    return dims, reach, None if order == (0, 1, 2) else order


def _check_inputs(positions, box, n_cells_dim, triclinic=False, axes=None):
    """float32 ``(B, N, 3)`` positions, one box per frame (``(B, 3)``
    lengths, or ``(B, 3, 3)`` matrices when `triclinic`) and the 3-D
    grid of :func:`_grid3` as a tuple; positions and lengths with their
    coordinates in the grid's order (a 2-D grid's kept axes first)."""

    positions = torch.as_tensor(positions)
    if positions.ndim == 2:
        positions = positions[None]
    if positions.ndim != 3 or positions.shape[-1] != 3:
        raise ValueError("positions must have shape (B, N, 3) or (N, 3).")
    positions = positions.to(torch.float32).contiguous()
    shape = (3, 3) if triclinic else (3,)
    box = torch.as_tensor(box, device=positions.device).to(torch.float32)
    if box.shape[-len(shape):] != shape or box.ndim > len(shape) + 1:
        raise ValueError(
            f"box must have shape {shape} or (B, *{shape}), not "
            f"{tuple(box.shape)}."
        )
    box = box.reshape(-1, *shape)
    box = box.expand(positions.shape[0], *shape).contiguous()
    dims, _, order = _grid3(n_cells_dim, axes=axes, triclinic=triclinic)
    if order is not None:
        positions = positions[..., order].contiguous()
        box = box[:, order].contiguous()
    return positions, box, dims


#: the sweep modes (:func:`_sweep_mode`) and, for each, the C entry
#: point of the self and of the cross kernel.
_ENTRIES = {
    "reach1": ("cell_pair_histogram_launch", "cross_pair_histogram_launch"),
    "general": ("cell_pair_histogram_launch", "cross_pair_histogram_launch"),
    "ordered": ("cell_pair_histogram_launch", None),
    "block": ("triclinic_cell_pair_histogram_launch",
              "triclinic_cross_pair_histogram_launch"),
    "tri_pp": ("tri_pp_cell_pair_histogram_launch",
               "tri_pp_cross_pair_histogram_launch"),
}

#: the self sweeps that visit every ordered cell pair once: identical
#: atoms dropped by id in the home block, counts not doubled.
_ORDERED_MODES = ("ordered", "tri_pp")


def _sweep_mode(n_cells_dim, reach, triclinic, cross):
    """The sweep a wrapper runs on this grid:

    * ``"reach1"`` -- orthorhombic, reach 1, at least 3 cells per axis:
      the 14-entry half shell (self) or the 27-entry full shell (cross);
    * ``"general"`` -- orthorhombic, any other grid: the deduped half
      table of :func:`_general_tables` (self; each unordered cell pair
      once, doubled) or its deduped full table (cross);
    * ``"ordered"`` -- orthorhombic self sweep of a grid without a half
      table (some axis has ``n_i < 2 m_i + 1``): the deduped full
      table, identical atoms dropped by id, counts not doubled;
    * ``"block"`` -- triclinic, reach 1, at least 3 cells per axis: one
      lattice translation per (cell, neighbour) block;
    * ``"tri_pp"`` -- triclinic, any other grid
      (:func:`plan_is_tri_pp`): the deduped full table and the per-pair
      27-candidate minimum image, ordered."""

    plan = {"n_cells_dim": n_cells_dim, "reach": reach}
    if triclinic:
        return "tri_pp" if plan_is_tri_pp(plan, True) else "block"
    if not _generalized(n_cells_dim, reach):
        return "reach1"
    if not cross and _general_tables(n_cells_dim, reach)[1] is None:
        return "ordered"
    return "general"


def _neighbors(dims, reach, mode, cross, device):
    """int64 ``(n_cells, n_nbr)`` neighbour table of a sweep mode."""

    if mode in ("reach1", "block"):
        table = _full_table(dims) if cross else _half_table(dims)
    else:
        full, half = _general_tables(dims, reach)
        table = half if mode == "general" and not cross else full
    return torch.as_tensor(table, device=device).long()


def _geometry(box, dims, mode, cross):
    """What the pairs of a sweep are binned with: the plain version's
    keyword arguments, and the kernel's geometry arguments (the
    orthorhombic lengths; the image table and the double-float shift
    table; or each frame's box matrix and its float32 inverse,
    flattened to ``(B, 18)``)."""

    if mode == "block":
        images = torch.as_tensor(
            _full_images(dims) if cross else _half_images(dims),
            device=box.device,
        )
        shifts = _image_shift_table(box)
        return (dict(box=None, images=images.long(), shifts=shifts),
                (images.contiguous(), *shifts))
    if mode == "tri_pp":
        inverse = _inv3(box)
        flat = torch.cat((box.reshape(-1, 9), inverse.reshape(-1, 9)), dim=1)
        return dict(box=box, inverse=inverse), (flat.contiguous(),)
    return dict(box=box), (box,)


def _poison(counts, box, dims, reach, r_max, mode):
    """float64 counts, NaN for frames whose box invalidates the planned
    grid: the strict per-block test, or the reach test on the box
    lengths or (tri_pp) the perpendicular widths."""

    if mode == "block":
        ok = _triclinic_sweep_ok(box, dims, r_max)
    else:
        extents = (triclinic_perpendicular_widths(box) if mode == "tri_pp"
                   else box)
        ok = _cell_sweep_ok(extents, dims, reach, r_max)
    return torch.where(ok[:, None], counts.to(torch.float64), torch.nan)


def _check_launchable(capacity1, capacity2, slot_bytes=_SLOT_BYTES):
    """Raise for capacities outside what the wrappers admit: each at most
    the planner's ceiling for slots of `slot_bytes` (:func:`_max_capacity`:
    4,096 slots of 16 bytes, 3,264 of 20), and for an asymmetric tile
    (20-byte slots) a multiple of 4, since its side ids are copied in
    16-byte pieces of a capacity row (the planner's capacities are
    multiples of 32).  Any ``n_bins`` launches: the kernels' shared memory
    does not grow with the capacity (``csrc/cell_sweep.cuh`` streams the
    neighbour slots through a fixed ring), and a histogram too wide for
    one shared copy beside it counts in global memory."""

    ceiling = _max_capacity(slot_bytes)
    if max(capacity1, capacity2) > ceiling:
        raise ValueError(
            f"Capacities {capacity1}/{capacity2} exceed the ceiling of "
            f"{ceiling} slots of {slot_bytes} bytes a cell (the planner's, "
            "sized by two slot blocks in a block's shared memory)."
        )
    if slot_bytes == _ASYM_SLOT_BYTES and capacity1 % 4:
        raise ValueError(
            f"An asymmetric tile exclusion needs a capacity that is a "
            f"multiple of 4, not {capacity1}."
        )


def _check_binning(r_max, r_min, precision):
    if precision not in ("exact", "fast"):
        raise ValueError("precision must be 'exact' or 'fast'.")
    if not 0.0 <= float(r_min) < float(r_max):
        raise ValueError(f"The range must satisfy 0 <= r_min < r_max, not "
                         f"[{r_min}, {r_max}].")


def _self_tiles(exclusion):
    """A self sweep's tile exclusion ``(e0, e1)``, or None for none and
    for ``(1, 1)``: every self sweep drops identical atoms (the JAX
    package's ``_exclusion_ids``)."""

    if exclusion is None:
        return None
    ex = tuple(int(e) for e in exclusion)
    if len(ex) != 2 or min(ex) < 1:
        raise ValueError("exclusion must be None or (e0, e1), both >= 1.")
    return None if ex == (1, 1) else ex


def _asym_diagonal(n_atoms, tiles):
    """The identical-atom pairs an asymmetric tile exclusion keeps
    (``i // e0 != i // e1``; distance 0), which every sweep drops and
    the wrapper adds back into bin 0."""

    atom = np.arange(n_atoms)
    return int(np.sum(atom // tiles[0] != atom // tiles[1]))


def _on_cpu(positions, what):
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); other devices raise."""

    if positions.device.type == "cpu":
        return True
    if positions.device.type != "cuda":
        raise ValueError(
            f"{what} runs on CUDA or CPU tensors, not "
            f"{positions.device.type}."
        )
    return False


def _launch(entry, device, *args):
    """Call the C entry point `entry` on the current stream of `device`;
    tensors pass as their data pointers, numpy floats as floats."""

    lib = _build.load_library()
    # A new name: `args` keeps the tensors made for this call alive until
    # the kernel is enqueued.
    values = [
        a.data_ptr() if isinstance(a, torch.Tensor)
        else float(a) if isinstance(a, np.floating) else a
        for a in args
    ]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, entry)(*values, stream)
    _build.check(status, f"{entry} kernel")


def _self_inputs(positions, box, n_cells_dim, capacity, triclinic,
                 reach=None, n_bins=0, mode=None, *, axes=None,
                 exclusion=None):
    """What the self kernel and its plain version share: the checked box
    and 3-D grid (:func:`_grid3`), the reach and the sweep mode, the slot
    table (with the second tile id of an asymmetric exclusion in column
    4) with its occupancy and maximum, and the mode's neighbour table
    (int64).  ``mode`` overrides :func:`_sweep_mode` (a cross-check runs
    tri_pp on a reach-1 grid)."""

    positions, box, dims = _check_inputs(positions, box, n_cells_dim,
                                         triclinic, axes)
    _, reach, _ = _grid3(n_cells_dim, reach, axes, triclinic)
    tiles = _self_tiles(exclusion)
    asym = tiles is not None and tiles[0] != tiles[1]
    _check_launchable(capacity, capacity,
                      _ASYM_SLOT_BYTES if asym else _SLOT_BYTES)
    mode = mode or _sweep_mode(dims, reach, triclinic, cross=False)
    if ((mode in _ORDERED_MODES or tiles is not None)
            and positions.shape[1] >= _MAX_EXACT_ID):
        raise ValueError(
            "The ordered sweep and the tile exclusions tell atoms apart by "
            f"float32 ids, exact only for groups under {_MAX_EXACT_ID} "
            "atoms."
        )
    ex = None if tiles is None else tiles[0]
    tables = _tables(positions, box, dims, capacity, ex=ex,
                     ex_j=tiles[1] if asym else None)
    nbr = _neighbors(dims, reach, mode, False, positions.device)
    return box, dims, reach, mode, tables, nbr


def _self_masks(mode, tiles):
    """The plain sweep's masks of a self sweep (:func:`_sweep_reference`)
    and whether its counts are doubled.  A half shell keeps the home
    block's strict slot triangle and doubles, unless an asymmetric tile
    weights each pair with its ordered multiplicity; a symmetric tile
    drops equal tile ids everywhere.  An ordered sweep drops identical
    atoms by id (by slot under a tile exclusion, whose ids are tiles)
    and applies the plain tile mask ``i // e0 != j // e1``; it is never
    doubled."""

    ordered = mode in _ORDERED_MODES
    asym = tiles is not None and tiles[0] != tiles[1]
    masks = dict(
        home_mask=("triangle" if not ordered
                   else "ids" if tiles is None else "diagonal"),
        exclude=tiles is not None and (ordered or not asym),
        asym=asym,
    )
    return masks, not ordered and not asym


def _self_finish(counts, n_atoms, box, dims, reach, r_max, r_min, mode,
                 tiles):
    """Kernel or plain counts as the wrapper returns them: doubled for
    a half shell without asymmetric weights; the identical-atom pairs an
    asymmetric tile keeps added into bin 0 (bins from 0 only: a range
    from ``r_min > 0`` leaves distance 0 out); NaN-poisoned per frame
    (:func:`_poison`)."""

    if _self_masks(mode, tiles)[1]:
        # Each unordered pair was visited once: double to ordered pairs.
        counts = counts * 2
    if tiles is not None and tiles[0] != tiles[1] and r_min == 0.0:
        counts[:, 0] += _asym_diagonal(n_atoms, tiles)
    return _poison(counts, box, dims, reach, r_max, mode)


def _self_reference(positions, box, r_max, n_cells_dim, capacity, n_bins,
                    triclinic, reach=None, mode=None, *, axes=None,
                    exclusion=None, r_min=0.0, precision="exact"):
    _check_binning(r_max, r_min, precision)
    box, dims, reach, mode, (table, occupancy, max_occ), nbr = _self_inputs(
        positions, box, n_cells_dim, capacity, triclinic, reach, n_bins,
        mode, axes=axes, exclusion=exclusion,
    )
    tiles = _self_tiles(exclusion)
    counts = _sweep_reference(
        table, occupancy, capacity, table, occupancy, capacity, nbr,
        r_max=r_max, n_bins=n_bins, r_min=r_min, precision=precision,
        n_axes=len(tuple(n_cells_dim)), **_self_masks(mode, tiles)[0],
        **_geometry(box, dims, mode, cross=False)[0],
    )
    n_atoms = torch.as_tensor(positions).shape[-2]
    return _self_finish(counts, n_atoms, box, dims, reach, r_max, r_min,
                        mode, tiles), max_occ


def _self_kernel(positions, box, r_max, n_cells_dim, capacity, n_bins,
                 triclinic, reach=None, mode=None, *, axes=None,
                 exclusion=None, r_min=0.0, precision="exact"):
    _check_binning(r_max, r_min, precision)
    box, dims, reach, mode, (table, occupancy, max_occ), nbr = _self_inputs(
        positions, box, n_cells_dim, capacity, triclinic, reach, n_bins,
        mode, axes=axes, exclusion=exclusion,
    )
    tiles = _self_tiles(exclusion)
    asym = tiles is not None and tiles[0] != tiles[1]
    side = None
    if asym:
        # The kernel reads 16-byte slots and the second ids beside them.
        side = table[..., 4].contiguous()
        table = table[..., :4].contiguous()
    device = box.device
    b = box.shape[0]
    out = torch.zeros((b, n_bins), dtype=torch.int64, device=device)
    sizes = (b, int(np.prod(dims)), nbr.shape[1], int(capacity),
             int(n_bins))
    if not triclinic:
        # The orthorhombic entry point takes the sweep's order and the
        # number of distance components.
        sizes += (int(mode == "ordered"), len(tuple(n_cells_dim)))
    _launch(_ENTRIES[mode][0], device, table, occupancy,
            nbr.to(torch.int32).contiguous(),
            *_geometry(box, dims, mode, cross=False)[1], out, *sizes,
            int(tiles is not None), int(asym), side,
            int(precision == "fast"),
            *_launch_constants(_bin_boundary_constants(r_max, n_bins,
                                                       r_min)))
    n_atoms = torch.as_tensor(positions).shape[-2]
    return _self_finish(out, n_atoms, box, dims, reach, r_max, r_min, mode,
                        tiles), max_occ


#: the optional modes a launch counts in a wrapper's ``option_launches``
#: (besides its sweep mode): bins from ``r_min > 0``, a symmetric and an
#: asymmetric tile exclusion of the self sweep, a 2-D grid, and float32
#: (fast) binning.
_OPTIONS = ("offset", "tiles", "asym", "2d", "fast")


def _count_launch(wrapper, n_cells_dim, reach, axes, triclinic, cross, *,
                  r_min, precision, exclusion=None):
    """Add one launch to `wrapper`'s counts: in all, by sweep mode and by
    option (:data:`_OPTIONS`)."""

    dims, reach, _ = _grid3(n_cells_dim, reach, axes, triclinic)
    wrapper.launches += 1
    wrapper.mode_launches[_sweep_mode(dims, reach, triclinic, cross)] += 1
    tiles = None if cross else _self_tiles(exclusion)
    options = wrapper.option_launches
    options["offset"] += int(r_min > 0.0)
    options["2d"] += int(len(tuple(n_cells_dim)) == 2)
    options["fast"] += int(precision == "fast")
    if tiles is not None:
        options["asym" if tiles[0] != tiles[1] else "tiles"] += 1


def _new_counts(wrapper, modes, options):
    """Set `wrapper`'s launch counts (in all, by sweep mode in `modes`,
    by option in `options`) to 0."""

    wrapper.launches = 0
    wrapper.mode_launches = dict.fromkeys(modes, 0)
    wrapper.option_launches = dict.fromkeys(options, 0)


def cell_pair_histogram_reference(
    positions, *, box, r_max, n_cells_dim, capacity, n_bins, reach=None,
    r_min=0.0, exclusion=None, axes=None, precision="exact",
):
    """Plain-torch version of the kernel: the same slot table, the same
    sweep and masks, the same binning; integer counts equal the
    kernel's.  Arguments and returns as :func:`cell_pair_histogram`."""

    return _self_reference(positions, box, r_max, n_cells_dim, capacity,
                           n_bins, triclinic=False, reach=reach, axes=axes,
                           exclusion=exclusion, r_min=r_min,
                           precision=precision)


def cell_pair_histogram(
    positions, *, box, r_max, n_cells_dim, capacity, n_bins, reach=None,
    r_min=0.0, exclusion=None, axes=None, precision="exact",
):
    r"""Self pair-distance histogram on ``[r_min, r_max]`` through the
    cell list; returns ``(counts, max_occupancy)``.

    Parameters
    ----------
    positions : `torch.Tensor`
        Coordinates ``(B, N, 3)`` (or one frame ``(N, 3)``), cast to
        float32, wrapped into the box (along the grid's axes).
    box : `torch.Tensor` or array-like
        Orthorhombic box lengths, ``(3,)`` or per frame ``(B, 3)``.
    r_max : `float`
        Histogram range ``[r_min, r_max]``.
    n_cells_dim, capacity, reach
        A plan from :func:`cell_plan_search` (``reach`` defaults to 1 on
        every axis).  A reach-1 grid of at least 3 cells per axis
        sweeps the 14-entry half shell; any other grid the deduped half
        table of :func:`_general_tables`, or, when it has none (a small
        box), the deduped full table in ordered mode (see
        :func:`_sweep_mode`).  A 2-entry ``n_cells_dim`` (a plan over two
        box lengths) is a 2-D grid over the coordinate columns ``axes``.
    n_bins : `int`
        Number of uniform bins.
    r_min : `float`, default 0
        Start of the range: above 0, the ``"offset"`` boundaries of
        :func:`_bin_boundary_constants` (closed last edge).
    exclusion : `tuple`, optional
        ``None`` or ``(1, 1)``: identical atoms dropped (every self
        sweep drops them).  ``(e0, e1)``: ordered pairs with ``i // e0
        == j // e1`` dropped too; an asymmetric tile (``e0 != e1``) keeps
        the identical-atom pairs with ``i // e0 != i // e1``, which are
        added into bin 0 when ``r_min`` is 0.
    axes : `tuple`, optional
        The coordinate columns the grid spans and the distance sums:
        ``(0, 1, 2)`` by default, two of them for a 2-D grid (the
        ``drop_axis`` RDF).
    precision : `str`, default ``"exact"``
        ``"exact"`` (double-float binning; the counts of a float64
        reference) or ``"fast"`` (the float32 distance, as the JAX
        package's ``_bin_fast``).  The JAX package's op defaults to
        ``"fast"``; the port's default keeps every caller exact.

    Returns
    -------
    counts : `torch.Tensor`
        float64 ``(B, n_bins)`` ordered-pair counts (each unordered pair
        counted twice), NaN for frames whose box is too small for the
        grid (:func:`_cell_sweep_ok`).
    max_occupancy : `torch.Tensor`
        int32 ``(B,)`` densest-cell occupancy; above ``capacity`` means
        the counts are incomplete (:class:`CellCapacityOverflow`).

    A CUDA tensor launches the kernel (and adds one to
    ``cell_pair_histogram.launches``, to its sweep mode's entry of
    ``cell_pair_histogram.mode_launches`` and to the entry of each option
    it runs in ``cell_pair_histogram.option_launches``); a CPU tensor runs
    :func:`cell_pair_histogram_reference`.  A plan the kernel cannot
    launch (slot blocks and histogram over 227 KB of shared memory)
    raises `ValueError` on either.
    """

    positions = torch.as_tensor(positions)
    options = dict(reach=reach, r_min=r_min, exclusion=exclusion, axes=axes,
                   precision=precision)
    if _on_cpu(positions, "cell_pair_histogram"):
        return cell_pair_histogram_reference(
            positions, box=box, r_max=r_max, n_cells_dim=n_cells_dim,
            capacity=capacity, n_bins=n_bins, **options,
        )
    out = _self_kernel(positions, box, r_max, n_cells_dim, capacity, n_bins,
                       triclinic=False, **options)
    _count_launch(cell_pair_histogram, n_cells_dim, reach, axes, False,
                  False, r_min=r_min, precision=precision,
                  exclusion=exclusion)
    return out


#: kernel launches made by :func:`cell_pair_histogram` (CUDA tensors
#: only), in all, by sweep mode and by option; a run sets them to 0 and
#: reads them back to show that its main path went through the kernel.
_new_counts(cell_pair_histogram, ("reach1", "general", "ordered"), _OPTIONS)


def triclinic_cell_pair_histogram_reference(
    positions, *, box, r_max, n_cells_dim, capacity, n_bins, reach=None,
    r_min=0.0, exclusion=None, precision="exact",
):
    """Plain-torch version of the triclinic self kernel: the same folded
    slot table, sweep, images and binning; integer counts equal the
    kernel's.  Arguments and returns as
    :func:`triclinic_cell_pair_histogram`."""

    return _self_reference(positions, box, r_max, n_cells_dim, capacity,
                           n_bins, triclinic=True, reach=reach,
                           exclusion=exclusion, r_min=r_min,
                           precision=precision)


def triclinic_cell_pair_histogram(
    positions, *, box, r_max, n_cells_dim, capacity, n_bins, reach=None,
    r_min=0.0, exclusion=None, precision="exact",
):
    r"""Self pair-distance histogram on ``[r_min, r_max]`` in a
    triclinic box (the triclinic modes of the JAX package's
    ``cell_pair_histogram_pallas``, batched over frames); returns
    ``(counts, max_occupancy)``.

    The positions are folded into the primary cell (the identity for
    positions already inside it) and gridded in fractional coordinates.
    On a reach-1 grid of at least 3 cells per axis every (cell,
    neighbour) block of the half shell takes one lattice translation,
    the minimum image of all its pairs within ``r_max``; on any other
    grid (:func:`plan_is_tri_pp`) the deduped full table is swept in
    ordered mode and every pair searches its 27 nearest images.

    Parameters
    ----------
    positions : `torch.Tensor`
        Coordinates ``(B, N, 3)`` (or one frame ``(N, 3)``), cast to
        float32.
    box : `torch.Tensor` or array-like
        Lower-triangular box matrices (rows are the box vectors,
        :func:`~mdhelper_tpu_torch.algorithm.topology.triclinic_matrices`),
        ``(3, 3)`` or per frame ``(B, 3, 3)``, cast to float32.
    r_max, n_bins, r_min, exclusion, precision
        As :func:`cell_pair_histogram`.
    n_cells_dim, capacity, reach
        A plan from :func:`cell_plan_search` over the perpendicular
        widths (:func:`triclinic_perpendicular_widths`); 3 axes.

    Returns
    -------
    counts : `torch.Tensor`
        float64 ``(B, n_bins)`` ordered-pair counts, NaN for frames
        whose perpendicular widths fall below ``n_cells_dim * r_max``
        (per-block grids: strictly, no 3-cell exception; tri_pp grids:
        the reach test of :func:`_cell_sweep_ok` on the widths).
    max_occupancy : `torch.Tensor`
        int32 ``(B,)`` densest-cell occupancy.

    A CUDA tensor launches the kernel (and adds one to
    ``triclinic_cell_pair_histogram.launches``, to
    ``.mode_launches["block"]`` or ``["tri_pp"]`` and to its options'
    entries of ``.option_launches``); a CPU tensor runs
    :func:`triclinic_cell_pair_histogram_reference`.
    """

    positions = torch.as_tensor(positions)
    options = dict(reach=reach, r_min=r_min, exclusion=exclusion,
                   precision=precision)
    if _on_cpu(positions, "triclinic_cell_pair_histogram"):
        return triclinic_cell_pair_histogram_reference(
            positions, box=box, r_max=r_max, n_cells_dim=n_cells_dim,
            capacity=capacity, n_bins=n_bins, **options,
        )
    out = _self_kernel(positions, box, r_max, n_cells_dim, capacity, n_bins,
                       triclinic=True, **options)
    _count_launch(triclinic_cell_pair_histogram, n_cells_dim, reach, None,
                  True, False, r_min=r_min, precision=precision,
                  exclusion=exclusion)
    return out


#: kernel launches made by :func:`triclinic_cell_pair_histogram`, read
#: the same way as ``cell_pair_histogram.launches``.
_new_counts(triclinic_cell_pair_histogram, ("block", "tri_pp"), _OPTIONS)


def _cross_inputs(positions1, positions2, box, n_cells_dim, capacity1,
                  capacity2, exclusion, triclinic, reach=None, n_bins=0,
                  mode=None, *, axes=None, id_offsets=(0, 0)):
    """What the cross kernel and its plain version share: the checked box
    and 3-D grid, the reach and the sweep mode, both groups' slot tables
    (exclusion ids in column 4, of each group's indices plus its entry of
    `id_offsets`) with their occupancies and maxima, and the mode's full
    table (int64).  ``mode`` as in :func:`_self_inputs`."""

    raw_box = box
    positions1, box, dims = _check_inputs(positions1, box, n_cells_dim,
                                          triclinic, axes)
    positions2 = torch.as_tensor(positions2)
    if positions2.device != positions1.device:
        raise ValueError("Both groups' positions must be on one device.")
    positions2, _, _ = _check_inputs(positions2, raw_box, n_cells_dim,
                                     triclinic, axes)
    if positions2.shape[0] != positions1.shape[0]:
        raise ValueError("Both groups need the same number of frames.")
    o1, o2 = (int(o) for o in id_offsets)
    if min(o1, o2) < 0 or max(o1 + positions1.shape[1],
                              o2 + positions2.shape[1]) > _MAX_EXACT_ID:
        raise ValueError(
            "The cross sweep stores atom ids as float32, exact only for "
            f"ids from 0 to {_MAX_EXACT_ID - 1}."
        )
    ex = (None, None) if exclusion is None else tuple(
        int(e) for e in exclusion
    )
    if len(ex) != 2 or (exclusion is not None and min(ex) < 1):
        raise ValueError("exclusion must be None or (e0, e1), both >= 1.")
    _check_launchable(capacity1, capacity2)
    _, reach, _ = _grid3(n_cells_dim, reach, axes, triclinic)
    mode = mode or _sweep_mode(dims, reach, triclinic, cross=True)
    tables1 = _tables(positions1, box, dims, capacity1, ex=ex[0],
                      id_offset=o1)
    tables2 = _tables(positions2, box, dims, capacity2, ex=ex[1],
                      id_offset=o2)
    nbr = _neighbors(dims, reach, mode, True, box.device)
    return box, dims, reach, mode, tables1, tables2, nbr


def _cross_reference(positions1, positions2, box, r_max, n_cells_dim,
                     capacity1, capacity2, n_bins, exclusion, triclinic,
                     reach=None, mode=None, *, axes=None, r_min=0.0,
                     precision="exact", id_offsets=(0, 0)):
    _check_binning(r_max, r_min, precision)
    (box, dims, reach, mode, (t1, occ1, max1), (t2, occ2, max2),
     nbr) = _cross_inputs(
        positions1, positions2, box, n_cells_dim, capacity1, capacity2,
        exclusion, triclinic, reach, n_bins, mode, axes=axes,
        id_offsets=id_offsets,
    )
    counts = _sweep_reference(
        t1, occ1, capacity1, t2, occ2, capacity2, nbr, r_max=r_max,
        n_bins=n_bins, home_mask=None, exclude=exclusion is not None,
        r_min=r_min, precision=precision, n_axes=len(tuple(n_cells_dim)),
        **_geometry(box, dims, mode, cross=True)[0],
    )
    return _poison(counts, box, dims, reach, r_max, mode), max1, max2


def _cross_kernel(positions1, positions2, box, r_max, n_cells_dim,
                  capacity1, capacity2, n_bins, exclusion, triclinic,
                  reach=None, mode=None, *, axes=None, r_min=0.0,
                  precision="exact", id_offsets=(0, 0)):
    _check_binning(r_max, r_min, precision)
    (box, dims, reach, mode, (t1, occ1, max1), (t2, occ2, max2),
     nbr) = _cross_inputs(
        positions1, positions2, box, n_cells_dim, capacity1, capacity2,
        exclusion, triclinic, reach, n_bins, mode, axes=axes,
        id_offsets=id_offsets,
    )
    device = box.device
    b = box.shape[0]
    out = torch.zeros((b, n_bins), dtype=torch.int64, device=device)
    flags = (int(exclusion is not None),)
    if not triclinic:
        # The orthorhombic entry point takes the number of components.
        flags += (len(tuple(n_cells_dim)),)
    _launch(_ENTRIES[mode][1], device, t1, occ1.contiguous(), t2,
            occ2.contiguous(), nbr.to(torch.int32).contiguous(),
            *_geometry(box, dims, mode, cross=True)[1], out, b,
            int(np.prod(dims)), nbr.shape[1], int(capacity1),
            int(capacity2), int(n_bins), *flags, int(precision == "fast"),
            *_launch_constants(_bin_boundary_constants(r_max, n_bins,
                                                       r_min)))
    return _poison(out, box, dims, reach, r_max, mode), max1, max2


def cross_pair_histogram_reference(
    positions1, positions2, *, box, r_max, n_cells_dim, capacity1,
    capacity2, n_bins, exclusion=None, reach=None, r_min=0.0, axes=None,
    precision="exact", id_offsets=(0, 0),
):
    """Plain-torch version of the cross kernel: the same two slot
    tables, the same sweep and masks, the same binning; integer counts
    equal the kernel's.  Arguments and returns as
    :func:`cross_pair_histogram`."""

    return _cross_reference(positions1, positions2, box, r_max,
                            n_cells_dim, capacity1, capacity2, n_bins,
                            exclusion, triclinic=False, reach=reach,
                            axes=axes, r_min=r_min, precision=precision,
                            id_offsets=id_offsets)


def cross_pair_histogram(
    positions1, positions2, *, box, r_max, n_cells_dim, capacity1,
    capacity2, n_bins, exclusion=None, reach=None, r_min=0.0, axes=None,
    precision="exact", id_offsets=(0, 0),
):
    r"""Cross-group pair-distance histogram on ``[r_min, r_max]``
    through the cell list: every (group-1, group-2) pair of two groups
    (the contract of the JAX package's
    ``cross_pair_histogram_pallas``, batched over frames); returns
    ``(counts, max_occ1, max_occ2)``.

    Parameters
    ----------
    positions1, positions2 : `torch.Tensor`
        Coordinates ``(B, N1, 3)`` and ``(B, N2, 3)`` (or one frame
        each), cast to float32, wrapped into the box.  No identical-atom
        mask is applied: groups may overlap, and an atom in both meets
        itself at distance 0, in bin 0 (unless the exclusion drops it),
        as in the JAX package's brute sweep.
    box : `torch.Tensor` or array-like
        Orthorhombic box lengths, ``(3,)`` or per frame ``(B, 3)``.
    r_max : `float`
        Histogram range ``[r_min, r_max]``.
    n_cells_dim, capacity1, capacity2, reach
        A cross plan from ``cell_plan_search(..., n_atoms2=)``
        (``capacity1`` is its ``"capacity"``; ``reach`` defaults to 1 on
        every axis).  A reach-1 grid of at least 3 cells per axis sweeps
        the 27-entry full shell, any other grid the deduped full table
        of :func:`_general_tables`; a 2-entry ``n_cells_dim`` is a 2-D
        grid over ``axes``.
    n_bins : `int`
        Number of uniform bins.
    exclusion : `tuple`, optional
        ``(e0, e1)``: drop pairs with ``i // e0 == j // e1`` on the
        group-local indices (molecule blocks; ``(1, 1)`` drops
        ``i == j``, as the Van Hove distinct part needs).
    r_min, axes, precision
        As :func:`cell_pair_histogram`.
    id_offsets : `tuple`, optional
        ``(o1, o2)``: the exclusion takes atom ``i`` of group 1 as index
        ``o1 + i`` and atom ``j`` of group 2 as ``o2 + j`` (blocks of
        larger groups, as the atom-sharded ring passes them; the ids
        stay under 2^24).

    Returns
    -------
    counts : `torch.Tensor`
        float64 ``(B, n_bins)`` ordered-pair counts (each pair once,
        not doubled), NaN for frames whose box is too small for the
        grid (:func:`_cell_sweep_ok`).
    max_occ1, max_occ2 : `torch.Tensor`
        int32 ``(B,)`` densest-cell occupancy of each group; above its
        capacity means the counts are incomplete.

    A CUDA tensor launches the kernel (and adds one to
    ``cross_pair_histogram.launches``, to its sweep mode's entry of
    ``cross_pair_histogram.mode_launches`` and to its options' entries of
    ``.option_launches``); a CPU tensor runs
    :func:`cross_pair_histogram_reference`.  A plan the kernel cannot
    launch raises `ValueError` on either.
    """

    positions1 = torch.as_tensor(positions1)
    options = dict(reach=reach, r_min=r_min, axes=axes, precision=precision,
                   id_offsets=id_offsets)
    if _on_cpu(positions1, "cross_pair_histogram"):
        return cross_pair_histogram_reference(
            positions1, positions2, box=box, r_max=r_max,
            n_cells_dim=n_cells_dim, capacity1=capacity1,
            capacity2=capacity2, n_bins=n_bins, exclusion=exclusion,
            **options,
        )
    out = _cross_kernel(positions1, positions2, box, r_max, n_cells_dim,
                        capacity1, capacity2, n_bins, exclusion,
                        triclinic=False, **options)
    _count_launch(cross_pair_histogram, n_cells_dim, reach, axes, False,
                  True, r_min=r_min, precision=precision)
    return out


#: kernel launches made by :func:`cross_pair_histogram` (CUDA tensors
#: only), read the same way as ``cell_pair_histogram.launches``.
_new_counts(cross_pair_histogram, ("reach1", "general"), _OPTIONS)


def triclinic_cross_pair_histogram_reference(
    positions1, positions2, *, box, r_max, n_cells_dim, capacity1,
    capacity2, n_bins, exclusion=None, reach=None, r_min=0.0,
    precision="exact",
):
    """Plain-torch version of the triclinic cross kernel: the same
    folded slot tables, sweep, images, masks and binning; integer counts
    equal the kernel's.  Arguments and returns as
    :func:`triclinic_cross_pair_histogram`."""

    return _cross_reference(positions1, positions2, box, r_max,
                            n_cells_dim, capacity1, capacity2, n_bins,
                            exclusion, triclinic=True, reach=reach,
                            r_min=r_min, precision=precision)


def triclinic_cross_pair_histogram(
    positions1, positions2, *, box, r_max, n_cells_dim, capacity1,
    capacity2, n_bins, exclusion=None, reach=None, r_min=0.0,
    precision="exact",
):
    r"""Cross-group pair-distance histogram on ``[r_min, r_max]`` in a
    triclinic box: :func:`cross_pair_histogram`'s contract (any two
    groups, optional ``(e0, e1)`` exclusion, counts not doubled, bins
    from ``r_min``, exact or fast) with
    :func:`triclinic_cell_pair_histogram`'s box, fold, grid, routes
    (per-block translations, or the per-pair 27-image search of
    tri_pp) and NaN rule.  ``box`` is ``(3, 3)`` or ``(B, 3, 3)``; the
    plan comes from ``cell_plan_search(widths, ..., n_atoms2=)`` over
    the perpendicular widths.  Returns ``(counts, max_occ1,
    max_occ2)``.

    A CUDA tensor launches the kernel (and adds one to
    ``triclinic_cross_pair_histogram.launches``, to
    ``.mode_launches["block"]`` or ``["tri_pp"]`` and to its options'
    entries of ``.option_launches``); a CPU tensor runs
    :func:`triclinic_cross_pair_histogram_reference`.
    """

    positions1 = torch.as_tensor(positions1)
    options = dict(reach=reach, r_min=r_min, precision=precision)
    if _on_cpu(positions1, "triclinic_cross_pair_histogram"):
        return triclinic_cross_pair_histogram_reference(
            positions1, positions2, box=box, r_max=r_max,
            n_cells_dim=n_cells_dim, capacity1=capacity1,
            capacity2=capacity2, n_bins=n_bins, exclusion=exclusion,
            **options,
        )
    out = _cross_kernel(positions1, positions2, box, r_max, n_cells_dim,
                        capacity1, capacity2, n_bins, exclusion,
                        triclinic=True, **options)
    _count_launch(triclinic_cross_pair_histogram, n_cells_dim, reach, None,
                  True, True, r_min=r_min, precision=precision)
    return out


#: kernel launches made by :func:`triclinic_cross_pair_histogram`, read
#: the same way as ``cell_pair_histogram.launches``.
_new_counts(triclinic_cross_pair_histogram, ("block", "tri_pp"), _OPTIONS)


def swept_pairs(positions1, positions2=None, *, box, n_cells_dim,
                triclinic=False, reach=None, axes=None):
    """Slot pairs with both slots occupied that the kernels bin for these
    inputs, summed over frames (an `int`): for one group, the home
    block's strict upper triangle plus the other blocks of a half-shell
    sweep, or the home block's off-diagonal pairs plus the other blocks
    of an ordered one; with `positions2`, every block of the cross
    sweep.  ``box`` is orthorhombic ``(3,)``/``(B, 3)``, or with
    `triclinic` ``(3, 3)``/``(B, 3, 3)``; ``reach`` and ``axes`` as the
    plan's.  The pair count of a kernel's operation bound; exclusion
    masks are not subtracted."""

    raw_box = box
    positions1, box, dims = _check_inputs(positions1, box, n_cells_dim,
                                          triclinic, axes)
    _, reach, _ = _grid3(n_cells_dim, reach, axes, triclinic)
    cross = positions2 is not None
    mode = _sweep_mode(dims, reach, triclinic, cross)
    nbr = _neighbors(dims, reach, mode, cross, box.device)
    _, occ1, _ = _tables(positions1, box, dims, _CAP_STEP)
    occ1 = occ1.long()
    if not cross:
        home = occ1 * (occ1 - 1)
        if mode not in _ORDERED_MODES:
            home = home // 2
        others = occ1[:, :, None] * occ1[:, nbr[:, 1:]]
        return int(home.sum() + others.sum())
    positions2, _, _ = _check_inputs(positions2, raw_box, n_cells_dim,
                                     triclinic, axes)
    _, occ2, _ = _tables(positions2, box, dims, _CAP_STEP)
    return int((occ1[:, :, None] * occ2.long()[:, nbr]).sum())
