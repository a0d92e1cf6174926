r"""
OpenMM topology transformations
===============================

As in :mod:`mdhelper_tpu.openmm.topology`.  Requires OpenMM.
"""

from itertools import repeat
from typing import Any, Iterable, Union

import numpy as np
from openmm import app

from ..algorithm import topology as _topology

__all__ = ["create_atoms", "get_subset"]


def create_atoms(*args, **kwargs) -> Any:
    """Alias of
    :func:`mdhelper_tpu_torch.algorithm.topology.create_atoms`."""

    return _topology.create_atoms(*args, **kwargs)


def _is_topology_object(obj: Any) -> bool:
    return isinstance(
        obj, (app.Atom, app.topology.Bond, app.Residue, app.Chain)
    )


def _hierarchy_indices(item, bonds: list):
    """The atom/bond/residue/chain index sets an item spans."""

    if isinstance(item, app.Atom):
        return (
            {item.index},
            set(),
            {item.residue.index},
            {item.residue.chain.index},
        )
    if isinstance(item, app.topology.Bond):
        return (
            {item.atom1.index, item.atom2.index},
            {bonds.index(item)},
            {item.atom1.residue.index, item.atom2.residue.index},
            {
                item.atom1.residue.chain.index,
                item.atom2.residue.chain.index,
            },
        )
    if isinstance(item, app.Residue):
        return (
            {a.index for a in item.atoms()},
            {bonds.index(b) for b in item.bonds()},
            {item.index},
            {item.chain.index},
        )
    if isinstance(item, app.Chain):
        atoms, bond_ids, residues = set(), set(), set()
        for residue in item.residues():
            a, b, r, _ = _hierarchy_indices(residue, bonds)
            atoms |= a
            bond_ids |= b
            residues |= r
        return atoms, bond_ids, residues, {item.index}
    raise TypeError(f"Unsupported topology item: {item!r}.")


def get_subset(
    topology: "app.Topology",
    positions: np.ndarray,
    *,
    delete: list = None,
    keep: list = None,
    types: Union[str, Iterable[str]] = None,
) -> tuple:
    r"""Subset a topology by deleting or keeping atoms, bonds,
    residues, or chains, resolved through ``openmm.app.Modeller``.

    Parameters
    ----------
    topology : `openmm.app.Topology`
    positions : array-like
        Positions matching `topology`.
    delete, keep : `list`, keyword-only
        Topology items (or integer indices with `types`) to remove or
        retain; mutually exclusive.
    types : `str` or iterable, keyword-only
        Item types (``"atom"``/``"bond"``/``"residue"``/``"chain"``)
        for integer entries.

    Returns
    -------
    topology, positions : `tuple`
        The subset topology and positions.
    """

    found = (delete is not None, keep is not None)
    if all(found):
        raise ValueError(
            "Only specify topology items to either delete or keep. "
            "When both types are specified, the atoms, bonds, "
            "residues, and/or chains to be removed from the topology "
            "become ambiguous."
        )
    if not any(found):
        return topology, positions

    items = delete if found[0] else keep
    if types is None and not all(
        _is_topology_object(i) for i in items
    ):
        verb = "deleted" if found[0] else "kept"
        raise ValueError(
            f"Object types must be specified for the topology items "
            f"to be {verb}."
        )
    if isinstance(types, str):
        same = True
        types = repeat(types)
    elif types is not None:
        types = list(types)
        same = all(t == "atoms" for t in types)

    modeller = app.Modeller(topology, positions)
    if types is not None:
        model = {
            "atom": list(topology.atoms()),
            "bond": list(topology.bonds()),
            "chain": list(topology.chains()),
            "residue": list(topology.residues()),
        }
        if found[0]:
            delete = (
                i if _is_topology_object(i) else model[t][i]
                for i, t in zip(delete, types)
            )
        else:
            atoms, bonds, residues, chains = set(), set(), set(), set()
            for item, item_type in zip(keep, types):
                if not _is_topology_object(item):
                    item = model[item_type][item]
                a, b, r, c = _hierarchy_indices(item, model["bond"])
                atoms |= a
                bonds |= b
                residues |= r
                chains |= c
            model["atom"] = np.delete(model["atom"], list(atoms))
            model["residue"] = np.delete(
                model["residue"], list(residues)
            )
            model["chain"] = np.delete(model["chain"], list(chains))
            if not bonds and same:
                model["bond"] = []
            else:
                for i in sorted(bonds, reverse=True):
                    del model["bond"][i]
            delete = [i for group in model.values() for i in group]
    modeller.delete(delete)
    return modeller.topology, modeller.positions
