"""A seeded random walk of atoms in a cube: the ``lj100k`` trajectory.

Frozen from the random walk of ``chip_smoke.py::isf_universe`` at commit
f7f3e8cd0aa08483990a67085713f35a76e682d8 (normal steps of ``step`` A a
frame and axis, wrapped into the box as float32), written in torch on the
device with one ``torch.Generator`` and a few large calls instead of
numpy on the host.  The starts are not uniform: each atom takes a site of
its own on a lattice of at least ``n_atoms`` cubes and a uniform place in
that cube, so that a region's count varies as little as in a liquid,
where density fluctuations are suppressed (uniform starts are an ideal
gas's Poisson counts, which overflowed the program's 4-sigma cell plan,
``CellCapacityOverflow``, on one seed of eight).  The float32 frames lie in ``[0, box)``: a
coordinate that rounds up to ``box`` is wrapped to 0, as the program's
own wrap does.
"""

import numpy as np
import torch


def make(config, n_frames, seed, device):
    """``(frames, dimensions)``: float32 ``(n_frames, n_atoms, 3)`` frames
    on the host and the box's six cell parameters."""

    n, box, step = int(config["n_atoms"]), float(config["box"]), float(
        config["step"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    walk = torch.randn((n_frames, n, 3), generator=gen, dtype=torch.float64,
                       device=device)
    walk *= step
    side = int(np.ceil(n ** (1 / 3) - 1e-9))
    site = torch.randperm(side**3, generator=gen, device=device)[:n]
    cube = torch.stack((site // side**2, (site // side) % side, site % side),
                       dim=1).to(torch.float64)
    jitter = torch.rand((n, 3), generator=gen, dtype=torch.float64,
                        device=device)
    walk[0] = (cube + jitter) * (box / side)
    walk = torch.cumsum(walk, dim=0)
    frames = torch.remainder(walk, box).to(torch.float32)
    del walk
    frames = torch.where(frames >= box, frames - box, frames)
    return (frames.cpu().numpy(),
            np.array([box, box, box, 90.0, 90.0, 90.0]))
