r"""
Accumulator checkpointing
=========================

The port's :mod:`mdhelper_tpu.core.checkpoint`: the carry of a streaming
analysis (histogram counts, rings, image flags), the number of frames it
has folded and, for store-type analyses, the host store state are
written to one ``.npz`` archive after every chunk, so a killed analysis
resumes mid-trajectory instead of recomputing.

The archive keeps the JAX package's layout: ``__frames_done__``,
``__n_leaves__``, ``leaf_{i}`` for the carry's leaves and ``store||{key}``
for the stores.  The carry is flattened as ``jax.tree.flatten`` orders a
pytree: dicts by sorted key, tuples and lists in order, ``None`` holding
no leaf.  The archive is written to, and read from, exactly the path
given (``np.savez`` adds ``.npz`` to a path that lacks it, which the JAX
package's ``os.path.exists`` check then never finds).
"""

import numpy as np
import torch

__all__ = ["save_carry", "load_carry"]


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flatten(item)]
    return [tree]


def _unflatten(template, leaves):
    """`template`'s structure with its leaves taken in order from the
    iterator `leaves`."""

    if template is None:
        return None
    if isinstance(template, dict):
        new = {key: _unflatten(template[key], leaves)
               for key in sorted(template)}
        return {key: new[key] for key in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(item, leaves) for item in template)
    return next(leaves)


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_carry(path: str, carry, frames_done: int, stores=None) -> None:
    """Write a carry (a tensor, or dicts, tuples and lists of them) and
    the number of processed frames to `path` itself.

    `stores` optionally adds host store state (per-frame result buffers
    and the store offset, from ``SerialAnalysisBase._store_state``) so
    that store-type analyses checkpoint too; its keys are saved under a
    ``store||`` prefix."""

    leaves = _flatten(carry)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    if stores:
        for key, value in stores.items():
            arrays[f"store||{key}"] = _host(value)
    with open(path, "wb") as file:
        np.savez(
            file,
            __frames_done__=np.int64(frames_done),
            __n_leaves__=np.int64(len(leaves)),
            **arrays,
        )


def load_carry(path: str, template, with_stores: bool = False):
    """Restore ``(carry, frames_done)`` from `path`, shaped like
    `template`: each leaf takes the dtype and device of the template's
    leaf.  With ``with_stores=True``, returns ``(carry, frames_done,
    stores)``, where `stores` maps the saved store keys back to arrays
    (empty for a carry-only checkpoint)."""

    with np.load(path) as archive:
        frames_done = int(archive["__frames_done__"])
        n_leaves = int(archive["__n_leaves__"])
        template_leaves = _flatten(template)
        if n_leaves != len(template_leaves):
            raise ValueError(
                f"Checkpoint has {n_leaves} leaves but the carry template "
                f"has {len(template_leaves)}; the analysis configuration "
                "changed."
            )
        leaves = []
        for i, ref in enumerate(template_leaves):
            value = archive[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                value = torch.as_tensor(value).to(device=ref.device,
                                                  dtype=ref.dtype)
            elif isinstance(ref, (bool, int, float)):
                value = type(ref)(value)
            leaves.append(value)
        carry = _unflatten(template, iter(leaves))
        if not with_stores:
            return carry, frames_done
        stores = {
            name[len("store||"):]: archive[name]
            for name in archive.files
            if name.startswith("store||")
        }
    return carry, frames_done, stores
