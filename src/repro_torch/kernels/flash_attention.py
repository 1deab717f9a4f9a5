"""Flash attention on the card: the wrapper around the CUDA kernel
``csrc/flash_attention.cu``, the port's counterpart of the Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

    out[b, s, h, :] = softmax_t(q[b, s, h] . k[b, t, h // G] * D**-0.5 + mask)
                      @ v[b, t, h // G]

with ``t <= s`` when causal, ``t > s - window`` when ``window > 0``; fp32
scores and accumulation, the output in q's dtype.  q is (B, S, H, D) and
k / v are (B, S, KV, D), all bf16 or all fp32, read in place through their
strides: the last axis must be contiguous and, for bf16, every row must
start on 16 bytes (what the TMA copies of the bf16 D = 128 kernel need).
D is 32, 64 or 128.

The backward, ``csrc/flash_attention_bwd.cu``, has no TPU counterpart
(the JAX package differentiates its jnp attention): dQ, dK and dV of the
same function for bf16 q / k / v with D = 64 or 128.  ``FlashAttention``
ties the two into one ``torch.autograd.Function``, which is what
``kernels/ops.flash_attention`` calls on CUDA tensors.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref.flash_attention_ref``.  ``launches``
counts launches: one a forward call, and one a backward call (which runs
the backward's three kernels, see the source).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.bfloat16, torch.float32)
BWD_HEAD_DIMS = (64, 128)
BWD_DTYPES = (torch.bfloat16,)
MAX_GRID_YZ = 65535     # H on gridDim.y, B on gridDim.z

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}


def _check_operand(t: torch.Tensor, name: str, device: torch.device,
                   dtype: torch.dtype) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} must be on {device} "
                         f"(cuda), got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                         f"{dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name} must be 4-D with a "
                         f"contiguous last axis, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if dtype == torch.bfloat16 and (t.data_ptr() % 16 or any(
            s % 8 for s in t.stride()[:3])):
        raise ValueError(f"flash_attention: bf16 {name} rows must start on "
                         f"16 bytes (strides {t.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) with H % KV == 0.  Returns a
    new contiguous (B, S, H, D) tensor in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: q must be on cuda, got {dev}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, dev, q.dtype)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, {S}, KV, {D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} heads over {KV} kv heads")
    if not (B <= MAX_GRID_YZ and H <= MAX_GRID_YZ and S < 2 ** 31):
        raise ValueError(f"flash_attention: unsupported shape "
                         f"{tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = _lib.library().repro_flash_attention(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        B, S, H, KV, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), int(window), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "flash_attention")
    launches["flash_attention"] += 1
    return out


def backward_supported(q: torch.Tensor) -> bool:
    """Whether the backward kernel takes q's dtype and head dim."""
    return q.dtype in BWD_DTYPES and q.shape[-1] in BWD_HEAD_DIMS


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` at the upstream
    gradient ``dout``, given its output ``out``; bf16, D = 64 or 128.
    Every operand is made contiguous; the gradients are new contiguous
    tensors in q's (k's) shape."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: q must be on cuda, got {dev}")
    if not backward_supported(q):
        raise ValueError(f"flash_attention_bwd: takes {BWD_DTYPES} with head "
                         f"dim in {BWD_HEAD_DIMS}, got {q.dtype} "
                         f"{tuple(q.shape)}")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    for t, name in ((k, "k"), (v, "v"), (out, "out"), (dout, "dout")):
        _check_operand(t, name, dev, q.dtype)
    B, S, H, D = q.shape
    KV = k.shape[2]
    if (tuple(k.shape) != (B, S, KV, D) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    if KV < 1 or H % KV or not (B <= MAX_GRID_YZ and H <= MAX_GRID_YZ):
        raise ValueError(f"flash_attention_bwd: unsupported heads {H} / {KV} "
                         f"or batch {B}")
    if window < 0:
        raise ValueError(f"flash_attention_bwd: window {window} < 0")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    rc = _lib.library().repro_flash_attention_bwd(
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), B, S, H, KV, D, int(bool(causal)),
        int(window), torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  Saves
    q, k, v and the output; under ``torch.utils.checkpoint`` the forward
    runs again in the backward pass, so it launches twice a step."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = flash_attention(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
