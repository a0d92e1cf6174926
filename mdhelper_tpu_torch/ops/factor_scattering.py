r"""
Tensor-factorized grid structure factor
=======================================

Torch counterpart of :mod:`mdhelper_tpu.ops.factor_scattering`.  For
wavevectors on the reciprocal lattice
:math:`\mathbf{q} = 2\pi(n_x/L_x, n_y/L_y, n_z/L_z)` the phase factor
separates by axis,

.. math::

   e^{i\mathbf{q}\cdot\mathbf{r}_j} = E_x[n_x, j]\,E_y[n_y, j]\,
   E_z[n_z, j], \qquad E_a[n, j] = e^{2\pi i\, n\, r_{ja}/L_a},

so the full grid needs only per-axis phase tables and a trilinear
contraction over the atom axis.  Exact mode builds the tables in
double-float arithmetic (:mod:`.doublefloat`): ``u = r / L`` as a float32
pair, ``n u`` formed error-free, reduced mod 1, and the residual applied
as a first-order trig correction.

:func:`factor_trig_sums` launches the hand-written kernel
``csrc/factor_sums.cu`` for CUDA tensors: one launch and one ordered
reduction for a whole batch of frames, tables and products kept on chip
(the JAX package has no Pallas kernel here; it leaves four float32
matmuls to XLA at ``Precision.HIGHEST``).  For CPU tensors it runs the
plain version, :func:`factor_trig_sums_reference`: the tables in eager
torch and the products as ``torch.matmul`` in full float32 (the package
forbids TF32 at import), frame by frame.
"""

import numpy as np
import torch

from .doublefloat import df_sub, f32_constant, two_prod
from .scattering import _check_precision

__all__ = [
    "factor_plan",
    "factor_trig_sums",
    "factor_trig_sums_reference",
    "factor_workspace",
]

_TWO_PI = 2 * np.pi
_TWO_PI_HI = np.float32(_TWO_PI)
_TWO_PI_LO = np.float32(_TWO_PI - np.float64(_TWO_PI_HI))


def factor_plan(wavevectors, dimensions, *, atol: float = 1e-8):
    """Map wavevectors onto per-axis integer grid indices (host side).

    Returns ``{"k": (Kx, Ky, Kz), "flat_idx": (N_q,) int64, "box":
    (Lx, Ly, Lz)}``; ``flat_idx`` gathers the caller's wavevector order
    out of the row-major ``(Kx, Ky, Kz)`` grid.  Raises `ValueError` if
    a wavevector is off the lattice or has a negative index.
    """

    dims = np.asarray(dimensions, np.float64)
    wavevectors = np.asarray(wavevectors, np.float64)
    n_float = wavevectors * dims / (2 * np.pi)
    n_int = np.rint(n_float).astype(np.int64)
    if not np.allclose(n_float, n_int, atol=atol):
        raise ValueError(
            "factorized scattering requires grid wavevectors "
            "q = 2*pi*n/L (no spherical surfaces or custom "
            "non-lattice wavevectors)."
        )
    if n_int.min() < 0:
        raise ValueError(
            "factorized scattering requires non-negative grid indices."
        )
    k = tuple(int(n_int[:, a].max()) + 1 for a in range(3))
    flat_idx = n_int[:, 0] * (k[1] * k[2]) + n_int[:, 1] * k[2] + n_int[:, 2]
    return {
        "k": k,
        "flat_idx": flat_idx,
        "box": tuple(float(d) for d in dims),
    }


def _axis_tables(x, length, n_max, exact):
    r"""Per-axis phase tables :math:`\cos/\sin(2\pi n x/L)` for
    :math:`n \in [0, n_\mathrm{max})`: two ``(n_max, N)`` float32
    tensors.  Periodic by construction, so unwrapped coordinates of
    either sign work."""

    def f32(value):
        return f32_constant(value, x.device)

    n = torch.arange(n_max, dtype=torch.float32, device=x.device)[:, None]
    length = f32(length)
    if exact:
        two_pi_hi = f32(_TWO_PI_HI)
        u_hi = x / length
        p_hi, p_lo = two_prod(u_hi, length)
        u_lo = ((x - p_hi) - p_lo) / length
        t_hi, t_lo = two_prod(n, u_hi[None, :])
        t_lo = t_lo + n * u_lo[None, :]
        m = torch.round(t_hi)
        v_hi, v_lo = df_sub((t_hi, t_lo), (m, torch.zeros_like(m)))
        a, b = two_prod(v_hi, two_pi_hi)
        theta_lo = b + v_hi * f32(_TWO_PI_LO) + v_lo * two_pi_hi
        cos_a, sin_a = torch.cos(a), torch.sin(a)
        return cos_a - theta_lo * sin_a, sin_a + theta_lo * cos_a
    t = n * (x / length)[None, :]
    theta = f32(_TWO_PI_HI) * (t - torch.round(t))
    return torch.cos(theta), torch.sin(theta)


def _atom_chunk(n_atoms: int, kx: int, ky: int) -> int:
    """Atom-chunk size bounding the ``(Kx*Ky, chunk)`` intermediates to
    ~64 MB each."""

    return min(max(512, (1 << 24) // max(1, kx * ky)), max(n_atoms, 1))


def _frame_sums(pos, w, k, box, exact):
    """The plain version's flattened row-major float32 ``(cos, sin)`` sums
    of one float32 frame ``(N, 3)`` over the full grid `k`."""

    kx, ky, kz = k
    n = pos.shape[0]
    chunk = _atom_chunk(n, kx, ky)
    re = torch.zeros((kx * ky, kz), dtype=torch.float32, device=pos.device)
    im = torch.zeros_like(re)
    for lo in range(0, n, chunk):
        p = pos[lo:lo + chunk]
        cx, sx = _axis_tables(p[:, 0], box[0], kx, exact)
        cy, sy = _axis_tables(p[:, 1], box[1], ky, exact)
        cz, sz = _axis_tables(p[:, 2], box[2], kz, exact)
        cxy = (cx[:, None, :] * cy[None] - sx[:, None, :] * sy[None])
        sxy = (sx[:, None, :] * cy[None] + cx[:, None, :] * sy[None])
        cxy = cxy.reshape(kx * ky, -1)
        sxy = sxy.reshape(kx * ky, -1)
        if w is not None:
            cz = cz * w[None, lo:lo + chunk]
            sz = sz * w[None, lo:lo + chunk]
        czt, szt = cz.T, sz.T
        re += cxy @ czt - sxy @ szt
        im += cxy @ szt + sxy @ czt
    return re.reshape(-1), im.reshape(-1)


def _factor_inputs(positions, weights, k, precision, flat_idx):
    """Checked inputs: float32 frames ``(B, N, 3)`` (and whether one frame
    was given), the weights, the grid extents and the int64 gather index
    (or None) on the positions' device.  Raises `ValueError` on a wrong
    type, dtype, shape, device or layout."""

    _check_precision(precision)
    if not isinstance(positions, torch.Tensor):
        raise ValueError("positions must be a torch.Tensor.")
    if positions.dtype != torch.float32:
        raise ValueError(
            f"positions must be float32, not {positions.dtype}.")
    if positions.ndim not in (2, 3) or positions.shape[-1] != 3:
        raise ValueError("positions must be (N, 3) or (B, N, 3).")
    if not positions.is_contiguous():
        raise ValueError("positions must be contiguous.")
    device = positions.device
    one_frame = positions.ndim == 2
    frames = positions[None] if one_frame else positions
    k = tuple(int(v) for v in k)
    if len(k) != 3 or min(k) < 1:
        raise ValueError("k must be three positive grid extents.")
    if weights is not None:
        if not isinstance(weights, torch.Tensor):
            raise ValueError("weights must be a torch.Tensor.")
        if (weights.dtype != torch.float32 or weights.device != device
                or weights.shape != (frames.shape[1],)
                or not weights.is_contiguous()):
            raise ValueError(
                f"weights must be a contiguous float32 ({frames.shape[1]},) "
                f"tensor on {device}.")
    if flat_idx is not None:
        flat_idx = torch.as_tensor(flat_idx, device=device)
        if flat_idx.dtype != torch.int64 or flat_idx.ndim != 1:
            raise ValueError("flat_idx must be a 1-D int64 index.")
        flat_idx = flat_idx.contiguous()
    return frames, one_frame, k, flat_idx


def factor_trig_sums_reference(positions, weights=None, *, k, box,
                               precision: str = "fast", flat_idx=None):
    """Plain-torch version of the kernel: :func:`_frame_sums` frame by
    frame, gathered through `flat_idx`.  Arguments and returns as
    :func:`factor_trig_sums` (less `workspace`)."""

    frames, one_frame, k, flat_idx = _factor_inputs(
        positions, weights, k, precision, flat_idx)
    exact = precision == "exact"
    sums = [_frame_sums(p, weights, k, box, exact) for p in frames]
    if flat_idx is not None:
        sums = [(c[flat_idx], s[flat_idx]) for c, s in sums]
    if one_frame:
        return sums[0]
    return (torch.stack([c for c, _ in sums]),
            torch.stack([s for _, s in sums]))


def factor_trig_sums(positions, weights=None, *, k, box,
                     precision: str = "fast", flat_idx=None,
                     workspace=None):
    r"""Weighted :math:`\sum_j w_j e^{i\mathbf{q}\cdot\mathbf{r}_j}`
    over the ``(Kx, Ky, Kz)`` reciprocal grid: float32 ``(cos, sin)``
    sums, row-major over the grid or, with `flat_idx`, in the caller's
    wavevector order.

    Parameters
    ----------
    positions : `torch.Tensor`
        Contiguous float32 coordinates ``(N, 3)`` or frames ``(B, N, 3)``
        (wrapped or not).
    weights : `torch.Tensor`, optional
        Contiguous float32 per-particle weights ``(N,)``.
    k : `tuple`
        Grid extents ``(Kx, Ky, Kz)``.
    box : `tuple`
        Box lengths ``(Lx, Ly, Lz)``.
    precision : `str`
        ``"fast"`` (float32 tables) or ``"exact"`` (double-float reduced
        arguments).
    flat_idx : `torch.Tensor` or array-like, optional
        int64 grid indices ``(N_q,)`` of the wanted wavevectors
        (``factor_plan(...)['flat_idx']``).  The kernel gives NaN sums for
        an index outside the grid (the plain version raises).
    workspace : `torch.Tensor`, optional
        The partial sums' scratch (:func:`factor_workspace`), made once by
        a caller that launches many times (CUDA tensors only; a call
        without one allocates its own).

    Returns
    -------
    cos_sum, sin_sum : `torch.Tensor`
        float32 ``(N_q,)`` each (``N_q = Kx Ky Kz`` without `flat_idx`),
        or ``(B, N_q)`` for frames.

    A CUDA tensor launches the kernel or raises: one launch and one
    reduction for all frames, counted once in
    ``factor_trig_sums.launches``, unless their partial sums would pass
    the workspace budget (256 MiB), when the frames go in groups, a launch
    a group.  A frame's sums are the same bits whatever frames share its
    call.  A CPU tensor runs :func:`factor_trig_sums_reference`.
    """

    from .cuda_cell_histogram import _on_cpu

    if isinstance(positions, torch.Tensor) and _on_cpu(
            positions, "factor_trig_sums"):
        return factor_trig_sums_reference(
            positions, weights, k=k, box=box, precision=precision,
            flat_idx=flat_idx)
    return _factor_sums_kernel(positions, weights, k, box, precision,
                               flat_idx, workspace)


#: a block's box of tiles at most (csrc/factor_sums.cu: kMaxThreads), the
#: ny rows and nz columns of a tile (kR, kC), the floats of a y and a z
#: group of a table row (kYStride, kZStride), and the shared memory a
#: block's tables may take.
_FACTOR_THREADS, _FACTOR_R, _FACTOR_C = 256, 4, 8
_FACTOR_Y_STRIDE, _FACTOR_Z_STRIDE = 12, 20
_FACTOR_SMEM = 48 * 1024
#: atoms a stage of the tables at most; blocks a launch aims for (six
#: waves of one block on each of an H100's 132 SMs); atoms a slice at
#: most (its partial sums are float32 stage sums added in float32).  At
#: 100k atoms and 8 frames on 24^3: slices of 2,048 atoms, 0.457 ms a
#: frame against 0.482 at 768 and 0.468 at 6,400 (NVIDIA H100 80GB HBM3,
#: 700 W).
_FACTOR_STAGE, _FACTOR_BLOCKS, _FACTOR_SLICE = 64, 6 * 132, 4096
#: frames a launch whose blocks the slices are cut to fill the card with.
#: The slices follow from K and n alone, never from the frames launched
#: together: a frame's sums are then the same bits in any chunk (a resumed
#: or rank-sharded run streams other chunks than an uninterrupted one).
_FACTOR_FILL_FRAMES = 8
#: bytes of float32 partial sums a launch may write: past it a call's
#: frames go in groups, a launch a group, and past that (one frame alone)
#: a slice takes more than _FACTOR_SLICE atoms.  43 MB at 8 frames of 100k
#: atoms on 24^3 (49 slices a frame), where it holds 49 frames a launch; 40
#: on 32^3 (25 slices a frame); on 64^3 one frame of 540k atoms takes
#: slices of more than 4,096 atoms.
_FACTOR_WORKSPACE = 256 << 20
#: CUDA's limit on the grid's second and third extents (slices, frames).
_GRID_YZ = 65535


def _balanced(extent, cap):
    """``(size, count)``: `extent` cut into `count` near-equal parts of at
    most `cap`."""

    count = -(-extent // cap)
    return -(-extent // count), count


def _factor_launch_plan(k, n_atoms, n_frames):
    """The kernel's tiling of grid `k` over `n_atoms` atoms and
    `n_frames` frames: a block's box of ``tx`` nx values, ``tyg`` y
    groups and ``tzg`` z groups, the boxes along each axis, the block's
    threads, its table stage, the atoms and the number of its slices (from
    `k` and `n_atoms` alone), the frames a launch, the float32 values of a
    launch's partial sums (``size``, within ``_FACTOR_WORKSPACE`` unless
    one slice of one frame passes it) and the most that any call of up to
    `n_frames` frames of up to `n_atoms` atoms on `k` takes (``bound``)."""

    kx, ky, kz = k
    n_grid = kx * ky * kz
    tzg, tiles_z = _balanced(-(-kz // _FACTOR_C), _FACTOR_THREADS)
    tyg, tiles_y = _balanced(-(-ky // _FACTOR_R), _FACTOR_THREADS // tzg)
    tx, tiles_x = _balanced(kx, _FACTOR_THREADS // (tyg * tzg))
    per_atom = 4 * (tyg * _FACTOR_Y_STRIDE + tzg * _FACTOR_Z_STRIDE
                    + 2 * tx + 6)
    stage = max(1, min(_FACTOR_STAGE, _FACTOR_SMEM // per_atom, n_atoms))
    tiles = tiles_x * tiles_y * tiles_z
    n_stages = -(-n_atoms // stage)
    most = max(1, _FACTOR_SLICE // stage)  # stages a slice at most
    # Slice-frames the budget holds: a frame's slices at most, and the
    # frames a launch.
    room = max(1, _FACTOR_WORKSPACE // (4 * 2 * n_grid))
    want = -(-_FACTOR_BLOCKS // (tiles * _FACTOR_FILL_FRAMES))
    stages = min(max(1, -(-n_stages // want)), most)
    stages = max(stages, -(-n_stages // _GRID_YZ), -(-n_stages // room))
    slices = -(-n_atoms // (stages * stage))
    frames = max(1, min(n_frames, _GRID_YZ, room // slices))
    # A frame's slices are at most `want` or those of `most` stages, and a
    # launch's slice-frames at most `room`; fewer atoms give a smaller or
    # equal stage count.
    bound = min(room, n_frames * max(want, -(-n_stages // most)))
    return {
        "tx": tx, "tyg": tyg, "tzg": tzg, "tiles_y": tiles_y,
        "tiles_z": tiles_z, "tiles": tiles,
        "threads": -(-tx * tyg * tzg // 32) * 32,
        "stage": stage, "split": stages * stage, "slices": slices,
        "frames": frames, "size": slices * frames * 2 * n_grid,
        "bound": bound * 2 * n_grid,
    }


def factor_workspace(k, n_atoms, n_frames, device):
    """A float32 buffer for the partial sums of :func:`factor_trig_sums`
    calls of up to `n_frames` frames of up to `n_atoms` atoms on grid `k`
    (43 MB at 8 frames of 100k atoms on 24^3; at most 256 MiB unless one
    slice of one frame takes more).  A caller that launches many times
    passes it as ``workspace=`` to every call."""

    k = tuple(int(v) for v in k)
    size = (_factor_launch_plan(k, n_atoms, n_frames)["bound"]
            if n_atoms and n_frames else 0)
    return torch.empty(size, dtype=torch.float32, device=device)


def _factor_sums_kernel(positions, weights, k, box, precision, flat_idx,
                        workspace=None):
    from .cuda_cell_histogram import _launch

    frames, one_frame, k, flat_idx = _factor_inputs(
        positions, weights, k, precision, flat_idx)
    device = frames.device
    b, n, _ = frames.shape
    n_q = k[0] * k[1] * k[2] if flat_idx is None else flat_idx.shape[0]
    cos = torch.zeros((b, n_q), dtype=torch.float32, device=device)
    sin = torch.zeros_like(cos)
    if n and n_q:
        plan = _factor_launch_plan(k, n, b)
        size = plan["size"]
        if workspace is None:
            workspace = torch.empty(size, dtype=torch.float32, device=device)
        elif (workspace.dtype != torch.float32 or workspace.device != device
              or workspace.numel() < size or not workspace.is_contiguous()):
            raise ValueError(
                f"the workspace must hold {size} contiguous float32 values "
                f"on {device}.")
        step = plan["frames"]
        for lo in range(0, b, step):
            # A group's partial sums are read by its reduction before the
            # next group's kernel writes them (one stream).
            _launch("factor_sums_launch", device, frames[lo:lo + step],
                    weights, flat_idx, workspace, cos[lo:lo + step],
                    sin[lo:lo + step], min(step, b - lo), n, *k, n_q,
                    plan["tx"], plan["tyg"], plan["tzg"], plan["tiles_y"],
                    plan["tiles_z"], plan["tiles"], plan["threads"],
                    plan["split"], plan["stage"], int(precision == "exact"),
                    *(np.float32(length) for length in box), _TWO_PI_HI,
                    _TWO_PI_LO)
            factor_trig_sums.launches += 1
    return (cos[0], sin[0]) if one_frame else (cos, sin)


#: kernel launches made by :func:`factor_trig_sums` (CUDA tensors only; a
#: launch is the kernel and its reduction); a run sets it to 0 and reads
#: it back to show that its path went through the kernel.
factor_trig_sums.launches = 0
