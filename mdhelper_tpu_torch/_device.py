"""
Device and dtype policy
=======================

* Coordinate streams are float32; accumulators are float64 (sums and
  pair counts, exact below 2^53) or int64.
* Float32 matrix products run in full float32.  TF32 keeps about three
  decimal digits, which would smear the factorized S(q) sums the same
  way a single bf16 pass on the TPU matrix unit does; the JAX package
  pins those products to ``Precision.HIGHEST`` for the same reason.
* Analyses run on the current CUDA device (``torch.cuda.current_device()``:
  the first card unless the process chose another, as each rank of a
  ``torchrun`` job does in
  :func:`~mdhelper_tpu_torch.parallel.mesh.initialize_distributed`)
  unless the caller passes another (``device="cpu"`` for the CPU);
  without a card the default raises instead of falling back.  Nothing
  here sets a global default device.
"""

import torch

__all__ = ["set_precision_policy", "require_cuda", "resolve_device"]


def set_precision_policy() -> None:
    """Forbid TF32 in float32 matrix products and convolutions."""

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def require_cuda() -> torch.device:
    """The current CUDA device (the first one unless the process set
    another); raises when there is no card."""

    if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available: this path runs only on a GPU."
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """``device=`` argument to a :class:`torch.device`: ``None`` is the
    current CUDA device (:func:`require_cuda`, which raises when there is
    no card)."""

    return require_cuda() if device is None else torch.device(device)
