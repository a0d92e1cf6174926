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

so the full grid needs only per-axis phase tables plus four real
float32 matrix products over the atom axis.  Exact mode builds the
tables in double-float arithmetic (:mod:`.doublefloat`): ``u = r / L``
as a float32 pair, ``n u`` formed error-free, reduced mod 1, and the
residual applied as a first-order trig correction.

The products are ``torch.matmul`` in full float32 (the package forbids
TF32 at import): like the JAX package, which leaves them to XLA at
``Precision.HIGHEST``, no hand kernel is involved.
"""

import numpy as np
import torch

from .doublefloat import df_sub, f32_constant, two_prod

__all__ = ["factor_plan", "factor_trig_sums"]

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


def factor_trig_sums(positions, weights=None, *, k, box,
                     precision: str = "fast"):
    r"""Weighted :math:`\sum_j w_j e^{i\mathbf{q}\cdot\mathbf{r}_j}`
    over the full ``(Kx, Ky, Kz)`` reciprocal grid; returns flattened
    row-major float32 ``(cos, sin)`` sums (gather a wavevector subset
    with ``factor_plan(...)['flat_idx']``).

    Parameters
    ----------
    positions : `torch.Tensor`
        Coordinates ``(N, 3)`` (wrapped or not).
    weights : `torch.Tensor`, optional
        Per-particle weights ``(N,)``.
    k : `tuple`
        Grid extents ``(Kx, Ky, Kz)``.
    box : `tuple`
        Box lengths ``(Lx, Ly, Lz)``.
    precision : `str`
        ``"fast"`` (float32 tables) or ``"exact"`` (double-float reduced
        arguments).
    """

    kx, ky, kz = (int(v) for v in k)
    exact = precision == "exact"
    pos = positions.to(torch.float32)
    n = pos.shape[0]
    w = None if weights is None else weights.to(torch.float32)
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
