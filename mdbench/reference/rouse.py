"""Rouse modes of unwrapped linear chains: the amplitudes ``X_p(t) =
(1 / N_p) sum_n r_n(t) cos(p pi (n + 1/2) / N_p)``, p = 1 .. n_modes;
their autocorrelations over origins and chains, each over its value at
lag 0, and their mean squares (``RouseModes``'s ``results.acf`` and
``results.mean_square_amplitudes``)."""

import numpy as np
import torch

from mdbench.reference._chains import autocorrelation, unwrapped_chains
from mdbench.reference._common import relative_gap


def expected(frames, dimensions, spec, device, dtype=torch.float64):
    chains = unwrapped_chains(frames, dimensions, spec, device, dtype)
    n_p = chains.shape[2]
    n_modes = int(spec["kwargs"]["n_modes"])
    p = np.arange(1, n_modes + 1)[:, None]
    mat = torch.as_tensor(
        np.cos(p * np.pi * (np.arange(n_p)[None, :] + 0.5) / n_p) / n_p,
        dtype=dtype, device=device)
    amps = torch.einsum("pn,tmnd->tmpd", mat, chains)
    acf = np.stack([autocorrelation(amps[:, :, k]) for k in range(n_modes)])
    msa = (amps * amps).sum(dim=-1).mean(dim=(0, 1)).double().cpu().numpy()
    return {"acf": acf / acf[:, :1], "mean_square_amplitudes": msa}


def judge(taken, want):
    acf = np.asarray(taken["acf"]).reshape(want["acf"].shape) if np.size(
        taken["acf"]) == want["acf"].size else np.full(1, np.nan)
    return {"rouse_gap": max(
        relative_gap(acf, want["acf"]),
        relative_gap(np.asarray(taken["mean_square_amplitudes"]).reshape(-1),
                     want["mean_square_amplitudes"]))}
