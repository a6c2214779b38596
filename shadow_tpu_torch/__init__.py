"""shadow_tpu_torch — the PyTorch/CUDA port of shadow_tpu's lane engine.

The batched discrete-event network simulator of ``shadow_tpu`` (one lane
per simulated host, key-sorted per-host event queues, a conservative
lookahead window loop), with its device kernels written by hand in CUDA
for NVIDIA Hopper.  This package imports ``torch`` and never ``jax`` or
``shadow_tpu``; the JAX package stays the reference it is tested against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(where the kernels' plain PyTorch versions run); without a card they
raise rather than fall back.  The command line is
``python -m shadow_tpu_torch [options] <config.yaml>`` (``--device cpu``
for the CPU).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and
    raises when there is none (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev
