"""
Utility algorithms
==================

Torch-free counterpart of :mod:`mdhelper_tpu.algorithm.utility`:
:func:`get_closest_factors`, which lays out the spherical-surface
wavevectors of :class:`~mdhelper_tpu_torch.analysis.structure.StructureFactor`,
the connected components of a bond graph (:func:`depth_first_search`,
:func:`find_connected_nodes`), unit-cell replication (:func:`replicate`)
and rebinning by averaging (:func:`rebin`).  NumPy only; prime factors
and divisors come from trial division, so the port needs no
computer-algebra package.
"""

from typing import Any

import numpy as np

__all__ = [
    "depth_first_search",
    "find_connected_nodes",
    "get_closest_factors",
    "rebin",
    "replicate",
]


def _prime_factors_desc(value: int) -> list:
    """The prime factors of `value`, with multiplicity, largest first."""

    primes, n, p = [], int(value), 2
    while p * p <= n:
        while n % p == 0:
            primes.append(p)
            n //= p
        p += 1
    if n > 1:
        primes.append(n)
    return primes[::-1]


def get_closest_factors(
    value: int, n_factors: int, reverse: bool = False
) -> np.ndarray:
    r"""Decompose :math:`N` into its :math:`n` closest integer factors,
    as :func:`mdhelper_tpu.algorithm.utility.get_closest_factors`: the
    greedy fill walks the prime factors of `value` from the largest down,
    packing primes into the current slot while the running product stays
    at or below :math:`\lceil N^{1/n}\rfloor` (a slot always accepts its
    first prime while slots remain), and spills any leftover prime onto
    the currently smallest slot.

    Parameters
    ----------
    value : `int`
        Number :math:`N` to factorize.
    n_factors : `int`
        Number of factors :math:`n` to return.
    reverse : `bool`, optional
        Sort the factors in descending instead of ascending order.

    Returns
    -------
    factors : `numpy.ndarray`
        The :math:`n` closest factors of :math:`N`. Shape: :math:`(n,)`.
    """

    root = value ** (1 / n_factors)
    root_int = int(np.round(root))
    if np.isclose(root, root_int):
        return np.full(n_factors, root_int, dtype=int)

    factors = np.ones(n_factors, dtype=int)
    slot = 0
    for rank, prime in enumerate(_prime_factors_desc(value)):
        placed = False
        while not placed:
            if slot >= n_factors:
                factors[np.argmin(factors)] *= prime
                placed = True
            else:
                trial = factors[slot] * prime
                first_fill = factors[slot] == 1 and rank < n_factors
                if trial <= root_int or first_fill:
                    factors[slot] = trial
                    placed = True
                else:
                    slot += 1
    factors = np.sort(factors)
    return factors[::-1] if reverse else factors


def depth_first_search(graph: dict, start: Any, visited: dict,
                       group: list) -> None:
    """Iterative depth-first search collecting one connected component,
    node for node in the JAX package's order: an explicit stack (so deep
    chain molecules cannot overflow Python's recursion limit) that pushes
    a node's unvisited neighbours in reverse, so they pop in adjacency
    order.  `visited` and `group` are updated in place."""

    stack = [start]
    visited[start] = True
    while stack:
        node = stack.pop()
        group.append(node)
        for neighbor in reversed(graph[node]):
            if not visited[neighbor]:
                visited[neighbor] = True
                stack.append(neighbor)


def find_connected_nodes(graph: dict) -> list:
    """The connected components of a graph (an adjacency mapping, node ->
    list of neighbours), each a list of nodes in DFS order, the
    components in the order of their first node in `graph`."""

    visited = dict.fromkeys(graph, False)
    results = []
    for start in graph:
        if not visited[start]:
            group = []
            depth_first_search(graph, start, visited, group)
            results.append(group)
    return results


def replicate(cell_dims: np.ndarray, cell_pos: np.ndarray,
              n_cells: np.ndarray) -> np.ndarray:
    r"""Replicate the :math:`N` points of a unit cell `cell_pos` ``(N,
    3)`` (cell lengths `cell_dims` ``(3,)``) `n_cells` ``(3,)`` times
    along x, y and z: ``(N n_x n_y n_z, 3)`` points, cell-major with the
    x replica varying fastest, then y, then z, the atoms of a cell
    contiguous (as :func:`mdhelper_tpu.algorithm.utility.replicate`)."""

    cell_dims = np.asarray(cell_dims, dtype=float)
    cell_pos = np.atleast_2d(np.asarray(cell_pos, dtype=float))
    nx, ny, nz = (int(n) for n in n_cells)
    shifts = np.stack(
        (
            np.tile(np.arange(nx), ny * nz),
            np.tile(np.repeat(np.arange(ny), nx), nz),
            np.repeat(np.arange(nz), nx * ny),
        ),
        axis=1,
    ) * cell_dims
    return (shifts[:, None, :] + cell_pos[None, :, :]).reshape(-1, 3)


def rebin(x: np.ndarray, factor: int = None) -> np.ndarray:
    r"""Rebin data along the last axis by averaging groups of `factor`
    values.  Without `factor`, the largest divisor of the last axis's
    length from 2 to 9 is taken (the JAX package asks sympy for the
    divisors; the same ones are found by trial division); `ValueError`
    when there is none."""

    x = np.asarray(x)
    if factor is None:
        divisors = [d for d in range(2, 10) if x.shape[-1] % d == 0]
        if not divisors:
            raise ValueError("No factor provided for rebinning.")
        factor = divisors[-1]
    return x.reshape(*x.shape[:-1], -1, factor).mean(axis=-1)
