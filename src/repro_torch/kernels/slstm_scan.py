"""The sLSTM scan on the card: the wrapper around the CUDA kernel
``csrc/slstm_scan.cu``, the port's counterpart of the Pallas kernel
``repro.kernels.slstm_scan.slstm_scan``.

From (c, n, h, m) = (0, 0, 0, -1e30) for each batch row, for each t:
``g = wx[:, t] + (h @ R head-major, (B, 4d)) + bias``, split into
``[i | f | z | o]``; i and f soft-capped at 15; ``m' = max(log_sigmoid(f) +
m, i)``, ``i' = exp(i - m')``, ``f' = exp(log_sigmoid(f) + m - m')``,
``c = f'c + i' tanh(z)``, ``n = f'n + i'``, ``h = sigmoid(o) c / max(n, 1)``.
All fp32; the output is h at every step, (B, S, d) fp32.

wx is (B, S, 4d) fp32, R is (H, P, 4P) bf16 or fp32, bias is (4d,) fp32,
all contiguous on one CUDA device; P is a multiple of 8 and d = H*P is at
most 2048.  One launch runs the whole scan, one thread-block cluster a
batch row.  ``plan`` says how the kernel lays a shape out: at P = 8, 16,
32, 64 and 192 (xlstm-125m's layer: 16 CTAs a row) each CTA keeps its
columns of R in registers and the CTAs exchange h through mbarriers; at
other P, R stays in shared memory (or, where 8 CTAs cannot hold it, is
read from device memory) and a cluster barrier publishes h each step.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref.slstm_scan_ref``.  ``launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _lib

R_DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 2048          # 4d gate columns over at most 8 CTAs of 1024 threads

launches: Dict[str, int] = {"slstm_scan": 0}


def _check(t: torch.Tensor, name: str, device: torch.device,
           shape, dtypes) -> None:
    if t.device != device:
        raise ValueError(f"slstm_scan: {name} must be on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"slstm_scan: {name} is {t.dtype}, want one of "
                         f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"slstm_scan: {name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"slstm_scan: {name} must be contiguous")


R_LIVES_IN = {1: "registers", 2: "shared memory", 3: "device memory"}


def plan(d: int, P: int, r_dtype: torch.dtype) -> dict:
    """The kernel's layout for a shape on the current card: the cluster
    size (CTAs a batch row) and where R lives during the scan
    (``R_LIVES_IN``); cluster 0 where the shape is not supported."""
    cluster, where = ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib.library().repro_slstm_scan_plan(
        d, P, int(r_dtype == torch.bfloat16), ctypes.byref(cluster),
        ctypes.byref(where))
    _lib.check(rc, "slstm_scan plan")
    return {"cluster": cluster.value,
            "r_lives_in": R_LIVES_IN.get(where.value)}


def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor,
               b_gates: torch.Tensor) -> torch.Tensor:
    """wx: (B, S, 4d) fp32; r_gates: (H, P, 4P); b_gates: (4d,) fp32.
    Returns a new contiguous (B, S, d) fp32 tensor of hidden states."""
    dev = wx.device
    if dev.type != "cuda":
        raise ValueError(f"slstm_scan: wx must be on cuda, got {dev}")
    if wx.dim() != 3 or r_gates.dim() != 3:
        raise ValueError(f"slstm_scan: wx {tuple(wx.shape)} must be "
                         f"(B, S, 4d), r_gates {tuple(r_gates.shape)} "
                         f"(H, P, 4P)")
    B, S, _ = wx.shape
    H, P, _ = r_gates.shape
    d = H * P
    _check(wx, "wx", dev, (B, S, 4 * d), (torch.float32,))
    _check(r_gates, "r_gates", dev, (H, P, 4 * P), R_DTYPES)
    _check(b_gates, "b_gates", dev, (4 * d,), (torch.float32,))
    if P % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"slstm_scan: unsupported head size P={P} / width "
                         f"d={d} (P a multiple of 8, d <= {MAX_D})")
    out = torch.empty((B, S, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    rc = _lib.library().repro_slstm_scan(
        out.data_ptr(), wx.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(),
        B, S, H, P, int(r_gates.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "slstm_scan")
    launches["slstm_scan"] += 1
    return out
