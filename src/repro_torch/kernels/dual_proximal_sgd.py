"""Dual-proximal SGD update on the card (paper Alg. 1 l.4, Eq. 6): the
wrapper around the CUDA kernel ``csrc/dual_proximal_sgd.cu``.

    out = w - (lr*scale[a]) * (g + mu1*(w - a1) + mu2*(w - a2))

The contract is the TPU kernel's (``repro.kernels.dual_proximal_sgd``)
plus two things the flat engine's inline step needs: a per-row step scale
(its ``live`` mask) and anchors that may be one ``(N,)`` row broadcast over
the ``A`` rows of ``w`` (the cloud master).  With no scale and full-shape
anchors it is the TPU kernel.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref``.  ``launches`` counts launches.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import _lib

ANCHOR_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 65535        # the kernel puts rows on gridDim.y

launches: Dict[str, int] = {"dual_proximal_sgd": 0}


def _anchor_stride(a: torch.Tensor, name: str, rows: int, n: int,
                   device: torch.device) -> int:
    if a.device != device:
        raise ValueError(f"{name}: expected {device}, got {a.device}")
    if a.dtype not in ANCHOR_DTYPES or not a.is_contiguous():
        raise ValueError(f"{name}: want a contiguous fp32|bf16 tensor, got "
                         f"{a.dtype} (contiguous={a.is_contiguous()})")
    if tuple(a.shape) == (rows, n):
        return n
    if tuple(a.shape) in ((n,), (1, n)):
        return 0
    raise ValueError(f"{name}: shape {tuple(a.shape)} is neither "
                     f"{(rows, n)} nor a broadcast ({n},) row")


def dual_proximal_sgd(w: torch.Tensor, g: torch.Tensor, a1: torch.Tensor,
                      a2: torch.Tensor, *, lr: float, mu1: float, mu2: float,
                      scale: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused update of fp32 ``w`` (any shape; rows are its first axis when
    2-D).  ``out`` may be ``w`` itself (in-place update); otherwise a new
    tensor is allocated."""
    dev = w.device
    if dev.type != "cuda":
        raise ValueError(f"dual_proximal_sgd: w must be on cuda, got {dev}")
    if w.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError("dual_proximal_sgd: w and g must be float32")
    if g.shape != w.shape or g.device != dev:
        raise ValueError("dual_proximal_sgd: g must match w")
    if not (w.is_contiguous() and g.is_contiguous()):
        raise ValueError("dual_proximal_sgd: w and g must be contiguous")
    rows, n = (w.shape[0], w[0].numel()) if w.dim() == 2 else (1, w.numel())
    if not (1 <= rows <= MAX_ROWS and n >= 1):
        raise ValueError(f"dual_proximal_sgd: unsupported shape "
                         f"{tuple(w.shape)}")
    if w.dim() != 2:        # one row: anchors must match w's shape
        a1, a2 = a1.reshape(-1), a2.reshape(-1)
    s1 = _anchor_stride(a1, "a1", rows, n, dev)
    s2 = _anchor_stride(a2, "a2", rows, n, dev)
    if scale is not None:
        if (tuple(scale.shape) != (rows,) or scale.dtype != torch.float32
                or scale.device != dev or not scale.is_contiguous()):
            raise ValueError(f"dual_proximal_sgd: scale must be a "
                             f"contiguous float32 ({rows},) tensor on {dev}")
    if out is None:
        out = torch.empty_like(w)
    elif (out.shape != w.shape or out.dtype != torch.float32
          or out.device != dev or not out.is_contiguous()):
        raise ValueError("dual_proximal_sgd: out must match w")
    rc = _lib.library().repro_dual_proximal_sgd(
        out.data_ptr(), w.data_ptr(), g.data_ptr(),
        a1.data_ptr(), s1, int(a1.dtype == torch.bfloat16),
        a2.data_ptr(), s2, int(a2.dtype == torch.bfloat16),
        None if scale is None else scale.data_ptr(), rows, n,
        float(lr), float(mu1), float(mu2),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "dual_proximal_sgd")
    launches["dual_proximal_sgd"] += 1
    return out
