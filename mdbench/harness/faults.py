"""Faults planted under the timed path, to show that the judgement sees
them: each breaks the per-chunk update of every analysis of a pass.

* ``unchanged``: the update returns the state it was given;
* ``half``: the second half of every chunk is left out, the first half
  counted in its place (the mean taken over the rest);
* ``altered``: one number of what each update produces is changed by 1.

``wrap(name)`` gives a function for ``passes.run_pass(wrap=...)``.  Over
ranks, ``exchange`` (the carries and stores left unreduced) belongs to a
cell of more than one rank.
"""

import torch

FAULTS = ("unchanged", "half", "altered")
#: the fault only a cell of more than one rank can have.
RANK_FAULTS = ("exchange",)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)


def _broken(update, fault, stores):
    def unchanged(carry, positions, dimensions, mask):
        out = update(carry, positions, dimensions, mask)
        return (carry, out[1]) if stores else carry

    def half(carry, positions, dimensions, mask):
        b = positions.shape[0]
        keep = (b + 1) // 2
        idx = torch.arange(b, device=positions.device) % keep
        return update(carry, positions[idx], dimensions, mask)

    def altered(carry, positions, dimensions, mask):
        out = update(carry, positions, dimensions, mask)
        produced = _leaves(out[1]) if stores else _leaves(out)
        for leaf in produced:
            if leaf.numel() and leaf.dtype != torch.bool:
                leaf[(0,) * leaf.ndim] += 1
                break
        return out

    return {"unchanged": unchanged, "half": half, "altered": altered}[fault]


def wrap(fault):
    """A ``wrap`` for :func:`mdbench.harness.passes.run_pass` that breaks
    every analysis's update with `fault`."""

    def apply(analyses):
        for a in analyses:
            if fault == "exchange":
                # Each rank keeps its own share of the carries.
                a._reduce_rank_carry = lambda carry: carry
                continue
            prepare = a._prepare

            def broken_prepare(a=a, prepare=prepare):
                prepare()
                a._update = _broken(a._update, fault,
                                    a._store_chunk is not None)

            a._prepare = broken_prepare

    return apply
