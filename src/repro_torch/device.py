"""Device selection shared by the port's entry points.

The entry points run on the card unless the caller asks for the CPU: with
``device=None`` they take ``cuda`` and raise when no GPU is present, so
nothing carries on quietly on the host.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` when ``device`` is None, else ``torch.device(device)``.

    Raises when CUDA is asked for (explicitly or by default) and absent.
    On a CUDA device it turns TF32 off for matmuls and cuDNN, so the MLP's
    fp32 ``bmm`` runs in full fp32 like the reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
