"""
Molecular structure
===================

Center-of-mass and radius-of-gyration algorithms, ported from
:mod:`mdhelper_tpu.algorithm.molecule`.  Torch tensors are reduced with
torch on their device and give tensors; anything else goes through
NumPy and gives arrays (the JAX package picks ``jax.numpy`` for its
arrays the same way).  Ragged groups (residues or segments of unequal
sizes) go through host loops, as in the JAX package.

Groups are duck-typed: any object with ``positions``, ``masses``,
``ix``, ``dimensions``, ``residues``/``segments`` and
``center_of_mass()`` works -- in particular
:class:`mdhelper_tpu_torch.core.universe.AtomGroup`.
"""

from typing import Any, Union

import numpy as np
import torch

__all__ = ["center_of_mass", "radius_of_gyration"]


def _validate_grouping(grouping: str) -> None:
    if grouping not in {None, "residues", "segments"}:
        emsg = (f"Invalid grouping: '{grouping}'. Valid options are "
                "None, 'residues', and 'segments'.")
        raise ValueError(emsg)


def _relative_indices(group, subgroup) -> np.ndarray:
    """Positions of `subgroup`'s atoms inside `group`'s position array."""

    order = np.argsort(group.ix)
    return order[np.searchsorted(group.ix, subgroup.ix, sorter=order)]


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _sum_keep(x, axis):
    """``x.sum(axis)`` keeping the summed axis, for arrays and tensors."""

    if isinstance(x, torch.Tensor):
        return x.sum(axis, keepdim=True)
    return x.sum(axis=axis, keepdims=True)


def _same_kind(masses, positions):
    """`masses` and `positions` as two tensors of their promoted dtype on
    the positions' device when `positions` is a tensor, else as two NumPy
    arrays."""

    if isinstance(positions, torch.Tensor):
        masses = torch.as_tensor(np.asarray(masses) if not isinstance(
            masses, torch.Tensor) else masses, device=positions.device)
        dtype = torch.promote_types(masses.dtype, positions.dtype)
        return masses.to(dtype), positions.to(dtype)
    return np.asarray(masses), np.asarray(positions)


def center_of_mass(
    group=None,
    grouping: str = None,
    *,
    masses: Union[list, np.ndarray] = None,
    positions: Union[list, np.ndarray] = None,
    images: np.ndarray = None,
    dimensions: np.ndarray = None,
    n_groups: int = None,
    raw: bool = False,
) -> Any:
    r"""Center(s) of mass of a collection of particles,

    .. math::

       \mathbf{R}_\mathrm{com}
       = \frac{\sum_i m_i \mathbf{r}_i}{\sum_i m_i},

    of an atom group (with `grouping` ``"residues"`` or ``"segments"``
    for one center a residue or segment) or of `masses` and `positions`
    given directly (`n_groups` equal groups, or lists of ragged ones).
    Equal-sized groups reshape to ``(n_groups, -1, 3)``.  With wrapped
    positions, `images` (boundary-crossing counts) and `dimensions`
    unwrap them first.

    Returns ``com``, or ``(com, masses, positions)`` with ``raw=True``
    when data was taken from `group`.
    """

    _validate_grouping(grouping)

    missing = (masses is None, positions is None)
    if any(missing):
        if group is None:
            emsg = ("Either a group of atoms or atom positions and "
                    "masses must be provided.")
            raise ValueError(emsg)

        if grouping:
            groups = list(getattr(group, grouping))
            same = all(
                g.atoms.n_atoms == groups[0].atoms.n_atoms for g in groups
            )
        else:
            groups = None
            same = True

        # Ragged groups, no unwrapping, no raw data: one center a group.
        if not same and images is None and not raw:
            return np.array([g.atoms.center_of_mass() for g in groups])

        if missing[1]:
            positions = np.array(group.positions)
            if images is not None:
                if dimensions is None:
                    dims = getattr(group, "dimensions", None)
                    if dims is None:
                        emsg = ("The number of periodic boundary "
                                "crossings was provided, but no system "
                                "dimensions were provided or found in "
                                "the trajectory.")
                        raise ValueError(emsg)
                    dimensions = np.asarray(dims)[:3]
                positions = positions + images * np.asarray(dimensions)[:3]

        if same:
            if missing[0]:
                masses = np.asarray(group.masses)
            if grouping or n_groups:
                n = n_groups if n_groups else getattr(group, f"n_{grouping}")
                masses = np.reshape(masses, (n, -1))
                positions = np.reshape(positions, (n, -1, 3))
        else:
            if missing[0]:
                masses = [np.asarray(g.atoms.masses) for g in groups]
            if missing[1]:
                positions = [positions[_relative_indices(group, g.atoms)]
                             for g in groups]
    else:
        # Arrays given directly: vectorize where they are rectangular.
        if not _is_array(positions):
            try:
                positions = np.asarray(positions, dtype=float)
                masses = np.asarray(masses, dtype=float)
            except ValueError:
                pass
            if isinstance(positions, np.ndarray) != isinstance(
                masses, np.ndarray
            ):
                emsg = ("The shapes of the arrays containing the "
                        "particle masses and positions are incompatible.")
                raise ValueError(emsg)
        if n_groups and _is_array(positions):
            masses = (masses.reshape(n_groups, -1)
                      if isinstance(masses, torch.Tensor)
                      else np.reshape(masses, (n_groups, -1)))
            positions = positions.reshape((n_groups, -1, 3))

    if _is_array(positions):
        m, p = _same_kind(masses, positions)
        xp = torch if isinstance(p, torch.Tensor) else np
        com = xp.einsum("...a,...ad->...d", m, p) / _sum_keep(m, -1)
        if raw and any(missing):
            masses = m
    else:
        com = np.array(
            [np.dot(m, p) / np.sum(m) for m, p in zip(masses, positions)]
        )

    if raw and any(missing):
        return com, masses, positions
    return com


def radius_of_gyration(
    group=None,
    grouping: str = None,
    *,
    positions: Union[list, np.ndarray] = None,
    masses: Union[list, np.ndarray] = None,
    com: np.ndarray = None,
    images: np.ndarray = None,
    dimensions: np.ndarray = None,
    n_groups: int = None,
    components: bool = False,
) -> Union[float, np.ndarray]:
    r"""Radii of gyration of a collection of particles,

    .. math::

       R_\mathrm{g} = \sqrt{\frac{\sum_i m_i
       \|\mathbf{r}_i - \mathbf{R}_\mathrm{com}\|^2}{\sum_i m_i}},

    taking the same inputs as :func:`center_of_mass` (and the centers
    `com`, computed when omitted).  With ``components=True`` the radii
    *around* each axis are returned (summing only the coordinate
    deviations orthogonal to it).
    """

    _validate_grouping(grouping)

    missing = (masses is None, positions is None, com is None)
    if any(missing[:2]):
        com, masses, positions = center_of_mass(
            group,
            grouping,
            masses=masses,
            positions=positions,
            raw=True,
            images=images,
            dimensions=dimensions,
        )
    elif missing[2]:
        com = center_of_mass(
            masses=masses, positions=positions, n_groups=n_groups
        )

    if _is_array(positions):
        masses, positions = _same_kind(masses, positions)
        torch_in = isinstance(positions, torch.Tensor)
        xp = torch if torch_in else np
        if torch_in:
            com = torch.as_tensor(com, device=positions.device).to(
                positions.dtype)
        grouped = bool(grouping) or bool(n_groups) or positions.ndim == 3
        if components:
            delta = positions - (com.unsqueeze(positions.ndim - 2)
                                 if torch_in else
                                 np.expand_dims(com, positions.ndim - 2))
            cpos = delta**2
            # Sum of squared deviations orthogonal to each axis.
            ortho = _sum_keep(cpos, -1) - cpos
            if grouped:
                return xp.sqrt(
                    xp.einsum("ga,gad->gd", masses, ortho)
                    / _sum_keep(masses, 1)
                )
            return xp.sqrt(xp.einsum("a,ad->d", masses, ortho) / masses.sum())
        if grouped:
            return xp.sqrt(
                xp.einsum("ga,gad->gd", masses,
                          (positions - com[:, None]) ** 2).sum(1)
                / masses.sum(1)
            )
        return xp.sqrt(
            xp.einsum("a,ad->d", masses, (positions - com) ** 2).sum()
            / masses.sum()
        )

    # Ragged groups: host loop.
    if components:
        gyradii = np.empty(np.shape(com))
        for i, (m, p, c) in enumerate(zip(masses, positions, com)):
            cpos = (np.asarray(p) - c) ** 2
            ortho = cpos.sum(axis=-1, keepdims=True) - cpos
            gyradii[i] = np.dot(np.asarray(m), ortho) / np.sum(m)
        return np.sqrt(gyradii)
    return np.sqrt(
        [
            np.einsum("a,ad->d", np.asarray(m),
                      (np.asarray(p) - c) ** 2).sum() / np.sum(m)
            for m, p, c in zip(masses, positions, com)
        ]
    )
