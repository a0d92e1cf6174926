"""Seeded linear chains in a cube: the ``melt100k`` trajectory.

Frozen from ``mdhelper_tpu_torch/testing.py::polymer_chains`` at commit
f7f3e8cd0aa08483990a67085713f35a76e682d8, as
``chip_smoke.py::polymer_universe`` calls it, written in torch on the
device with one ``torch.Generator`` and a few large calls.  A chain's
conformation (each monomer relative to its first) is a Gaussian walk
whose bonds are ``stiffness`` times the bond before plus ``sqrt(1 -
stiffness^2)`` times a fresh N(0, ``bond / sqrt(3)``) step an axis; from
frame to frame the conformation is ``memory`` times the last one plus
``sqrt(1 - memory^2)`` times a fresh walk, and the first monomer takes a
N(0, ``drift``) step an axis from a uniform start.  Chains are stored one
after another and wrapped atom by atom into ``[0, box)`` as float32.
"""

import numpy as np
import torch


def make(config, n_frames, seed, device):
    """``(frames, dimensions)``: float32 ``(n_frames, n_chains *
    n_monomers, 3)`` frames on the host and the box's cell parameters."""

    m, n_p = int(config["n_chains"]), int(config["n_monomers"])
    box = float(config["box"])
    bond, stiffness = float(config["bond"]), float(config["stiffness"])
    memory, drift = float(config["memory"]), float(config["drift"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    kw = dict(generator=gen, dtype=torch.float64, device=device)

    # One walk a frame, all frames at once: (T, M, N_p - 1, 3) steps.
    steps = torch.randn((n_frames, m, n_p - 1, 3), **kw) * (
        bond / np.sqrt(3.0))
    mix = np.sqrt(1.0 - stiffness**2)
    bonds = torch.empty_like(steps)
    carry = steps[:, :, 0]
    bonds[:, :, 0] = carry
    for k in range(1, n_p - 1):
        carry = stiffness * carry + mix * steps[:, :, k]
        bonds[:, :, k] = carry
    walks = torch.cat((torch.zeros((n_frames, m, 1, 3), dtype=torch.float64,
                                   device=device),
                       torch.cumsum(bonds, dim=2)), dim=2)
    del steps, bonds
    conformation = torch.empty_like(walks)
    conformation[0] = walks[0]
    fresh = np.sqrt(1.0 - memory**2)
    for t in range(1, n_frames):
        conformation[t] = memory * conformation[t - 1] + fresh * walks[t]
    del walks
    heads = torch.randn((n_frames, m, 3), **kw) * drift
    heads[0] = torch.rand((m, 3), **kw) * box
    heads = torch.cumsum(heads, dim=0)
    unwrapped = (heads[:, :, None] + conformation).reshape(n_frames, -1, 3)
    del conformation
    frames = torch.remainder(unwrapped, box).to(torch.float32)
    del unwrapped
    frames = torch.where(frames >= box, frames - box, frames)
    return (frames.cpu().numpy(),
            np.array([box, box, box, 90.0, 90.0, 90.0]))
