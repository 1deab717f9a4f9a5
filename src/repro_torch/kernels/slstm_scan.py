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

With ``return_state=True`` the kernel also writes the state after every
step, (B, S, 3, d) fp32 holding (c, n, m), for the backward.

The backward, ``csrc/slstm_scan_bwd.cu``, has no TPU counterpart (the
reference differentiates its ``lax.scan`` with ``jax.grad``): the reverse
scan over t, one thread-block cluster a batch row, each CTA holding its
rows of R (viewed as (d, 4P)) in shared memory (or reading them from device
memory where the cluster cannot hold R), one cluster barrier a step, which
carries (dc, dn, dm) and dh_{t-1} = R[head] . dg_t[head] and writes the
gates' gradient dg = dwx.  ``slstm_scan_bwd`` recomputes the gates with one
batched product before it and forms dR and db with one after it
(``_gates`` / ``_weight_grads``).  ``SLSTMScan`` ties
the two into one ``torch.autograd.Function``, which is what
``kernels/ops.slstm_scan`` calls on CUDA tensors that need a gradient.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref.slstm_scan_ref``.  ``launches`` counts
launches: one a forward call (``slstm_scan``), one a backward call
(``slstm_scan_bwd``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _lib

R_DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 2048          # 4d gate columns over at most 8 CTAs of 1024 threads

launches: Dict[str, int] = {"slstm_scan": 0, "slstm_scan_bwd": 0}


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


def bwd_plan(d: int, P: int, r_dtype: torch.dtype) -> dict:
    """The backward kernel's layout on the current card: the cluster size
    (0 where the shape is not supported), where R lives during the reverse
    scan and the threads a unit splits its dot over."""
    cluster, where, ks = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = _lib.library().repro_slstm_scan_bwd_plan(
        d, P, int(r_dtype == torch.bfloat16), ctypes.byref(cluster),
        ctypes.byref(where), ctypes.byref(ks))
    _lib.check(rc, "slstm_scan_bwd plan")
    return {"cluster": cluster.value,
            "r_lives_in": R_LIVES_IN.get(where.value),
            "threads_a_unit": ks.value}


def _check_shapes(wx: torch.Tensor, r_gates: torch.Tensor,
                  b_gates: torch.Tensor, name: str):
    """(B, S, H, P) of a call, after checking wx, R and the bias."""
    dev = wx.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: wx must be on cuda, got {dev}")
    if wx.dim() != 3 or r_gates.dim() != 3:
        raise ValueError(f"{name}: wx {tuple(wx.shape)} must be "
                         f"(B, S, 4d), r_gates {tuple(r_gates.shape)} "
                         f"(H, P, 4P)")
    B, S, _ = wx.shape
    H, P, _ = r_gates.shape
    d = H * P
    _check(wx, "wx", dev, (B, S, 4 * d), (torch.float32,))
    _check(r_gates, "r_gates", dev, (H, P, 4 * P), R_DTYPES)
    _check(b_gates, "b_gates", dev, (4 * d,), (torch.float32,))
    if P % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"{name}: unsupported head size P={P} / width "
                         f"d={d} (P a multiple of 8, d <= {MAX_D})")
    return B, S, H, P


def slstm_scan(wx: torch.Tensor, r_gates: torch.Tensor,
               b_gates: torch.Tensor, *, return_state: bool = False):
    """wx: (B, S, 4d) fp32; r_gates: (H, P, 4P); b_gates: (4d,) fp32.
    Returns a new contiguous (B, S, d) fp32 tensor of hidden states, and
    with ``return_state`` also the (B, S, 3, d) fp32 state (c, n, m)
    after every step."""
    B, S, H, P = _check_shapes(wx, r_gates, b_gates, "slstm_scan")
    dev, d = wx.device, H * P
    out = torch.empty((B, S, d), dtype=torch.float32, device=dev)
    state = (torch.empty((B, S, 3, d), dtype=torch.float32, device=dev)
             if return_state else None)
    if out.numel():
        rc = _lib.library().repro_slstm_scan(
            out.data_ptr(), 0 if state is None else state.data_ptr(),
            wx.data_ptr(), r_gates.data_ptr(), b_gates.data_ptr(), B, S, H,
            P, int(r_gates.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(rc, "slstm_scan")
        launches["slstm_scan"] += 1
    return (out, state) if return_state else out


def _gates(wx, r_gates, b_gates, h) -> torch.Tensor:
    """The gate pre-activations g_t = wx_t + h_{t-1} @ R (head-major) + bias
    at every step, (B, S, 4d) fp32, from the scan's output h (B, S, d)
    (h_{-1} = 0): one batched product."""
    B, S, d = h.shape
    H, P, _ = r_gates.shape
    h_prev = torch.cat((h.new_zeros(B, 1, d), h[:, :-1]), dim=1)
    rec = torch.einsum("bshp,hpq->bshq", h_prev.reshape(B, S, H, P),
                       r_gates.float()).reshape(B, S, 4 * d)
    return wx + rec + b_gates


def _weight_grads(h, dg, r_gates):
    """(dR in R's dtype, db fp32) from the scan's output h (B, S, d) and the
    gates' gradient dg (B, S, 4d): dR[head] = sum over b, t of
    h_{t-1}[head]^T dg_t[head] (one batched product) and db = sum dg_t."""
    B, S, d = h.shape
    H, P, _ = r_gates.shape
    h_prev = torch.cat((h.new_zeros(B, 1, d), h[:, :-1]), dim=1)
    dr = torch.einsum("nhp,nhq->hpq", h_prev.reshape(B * S, H, P),
                      dg.reshape(B * S, H, 4 * P))
    return dr.to(r_gates.dtype), dg.sum(dim=(0, 1))


def slstm_scan_bwd(dh: torch.Tensor, wx: torch.Tensor, r_gates: torch.Tensor,
                   b_gates: torch.Tensor, h: torch.Tensor,
                   state: torch.Tensor):
    """(dwx (B, S, 4d) fp32, dR in R's dtype, db (4d,) fp32) of
    ``slstm_scan(wx, r_gates, b_gates)`` at the upstream gradient dh (B, S,
    d) fp32, given its output h and state (``return_state=True``).  The
    gates g_t are recomputed from h (one batched product), the kernel runs
    the reverse scan into dg = dwx, and dR, db follow from dg (one batched
    product and a sum)."""
    B, S, H, P = _check_shapes(wx, r_gates, b_gates, "slstm_scan_bwd")
    dev, d = wx.device, H * P
    dh = dh.contiguous()
    for t, name, shape in ((dh, "dh", (B, S, d)), (h, "h", (B, S, d)),
                           (state, "state", (B, S, 3, d))):
        _check(t, name, dev, shape, (torch.float32,))
    g = _gates(wx, r_gates, b_gates, h)
    dg = torch.empty_like(g)
    if dg.numel():
        rc = _lib.library().repro_slstm_scan_bwd(
            dg.data_ptr(), dh.data_ptr(), g.data_ptr(), state.data_ptr(),
            r_gates.data_ptr(), B, S, H, P,
            int(r_gates.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(rc, "slstm_scan_bwd")
        launches["slstm_scan_bwd"] += 1
    del g
    dr, db = _weight_grads(h, dg, r_gates)
    return dg, dr, db


class SLSTMScan(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  When a
    gradient is wanted, the forward also writes the state after every step
    and saves it with wx, R, the bias and the output; under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass
    (and writes it again), so it launches twice a step."""

    @staticmethod
    def forward(ctx, wx, r_gates, b_gates):
        if any(ctx.needs_input_grad):
            out, state = slstm_scan(wx, r_gates, b_gates, return_state=True)
            ctx.save_for_backward(wx, r_gates, b_gates, out, state)
        else:
            out = slstm_scan(wx, r_gates, b_gates)
        return out

    @staticmethod
    def backward(ctx, dh):
        wx, r_gates, b_gates, out, state = ctx.saved_tensors
        return slstm_scan_bwd(dh.float(), wx, r_gates, b_gates, out, state)
