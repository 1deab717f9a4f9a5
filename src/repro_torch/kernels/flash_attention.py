"""Flash attention on the card: the wrapper around the CUDA kernel
``csrc/flash_attention.cu``, the port's counterpart of the Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

    out[b, s, h, :] = softmax_t(q[b, s, h] . k[b, t, h // G] * D**-0.5 + mask)
                      @ v[b, t, h // G]

with ``t <= s`` when causal, ``t > s - window`` when ``window > 0``; fp32
scores and accumulation, the output in q's dtype.  q is (B, S, H, D), k is
(B, S, KV, D) and v (B, S, KV, Dv), all bf16 or all fp32, read in place
through their strides: the last axis must be contiguous and, for bf16,
every row must start on 16 bytes (what the TMA copies need).  (D, Dv) is
(32, 32), (64, 64), zamba2-2.7b's (80, 80), (128, 128) or MLA's (192,
128): deepseek-v2-lite's prefill folds 64 RoPE dims into q and k and keeps
v at 128, where the reference zero-pads v to 192 (``HEAD_DIMS``).  In
bf16, (128, 128), MLA's (192, 128) and (80, 80) run one warp-specialised
kernel (TMA copies into an mbarrier ring, wgmma products; a q/k row is
two or three 128-byte boxes, the second of an 80-wide row zero past its
16 columns, and PV a wgmma m64n<Dv>k16; blocks ordered in groups of 16
(b, h) pairs, so that the blocks in flight share K/V in the L2), and D =
32 / 64 an mma.sync kernel; fp32 runs on the FMA units.  The probabilities stay fp32, as bf16 hi + lo parts
through the tensor cores, so the output agrees with the plain version to
about one bf16 ulp elementwise (a single bf16 P would not, on outputs
near zero).

With ``return_lse=True`` the bf16 forward also returns each row's
log-sum-exp, the fp32 (B, H, S) ``log2 sum_t 2^(score_t * D**-0.5 *
log2 e)`` over the live keys (``kernels/ref.attention_lse_ref``), written in
the kernel's epilogue; without it the kernel stores nothing more.

The backward, ``csrc/flash_attention_bwd.cu``, has no TPU counterpart
(the JAX package differentiates its jnp attention): dQ, dK and dV of the
same function for bf16 q / k / v with D = 64 or 128, from the forward's
output and saved lse.  It does 5 products a live (query, key) pair (S,
dP, dV, dK, dQ) in one fused kernel a (key tile, KV head, batch row): at
D = 128 two wgmma warpgroups of 64 keys each, fed by TMA through a
2-stage ring (register budget of a thread: 128 fp32 for the dK and dV
accumulators across the loop, 32 for half a tile's S^T and dP^T, 32 for
the dQ share; 236 in all with addressing, under the 255 of a 256-thread
block, see the source); at D = 64 mma.sync with cp.async double
buffering.  dQ of the key tiles sums into an fp32 scratch by bulk
reduce-adds in no fixed order, so it may differ in its last bits from run
to run.  ``FlashAttention`` ties the two into one
``torch.autograd.Function``, which is what ``kernels/ops.flash_attention``
calls on CUDA tensors.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref.flash_attention_ref``.  ``launches``
counts launches: one a forward call (under ``flash_attention_mla`` at
MLA's head dims and ``flash_attention_d80`` at zamba2's 80), and one a
backward call (which runs the backward's three kernels: prep, the fused
kernel, the dQ pass).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128),
             (192, 128))                                   # (D, Dv)
DTYPES = (torch.bfloat16, torch.float32)
BWD_HEAD_DIMS = (64, 128)
BWD_DTYPES = (torch.bfloat16,)
MAX_GRID_YZ = 65535     # H on gridDim.y, B on gridDim.z

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_mla": 0,
                            "flash_attention_d80": 0,
                            "flash_attention_bwd": 0}


def _launch_key(D: int, Dv: int) -> str:
    """The count a forward launch at head dims (D, Dv) adds to."""
    if D != Dv:
        return "flash_attention_mla"
    return "flash_attention_d80" if D == 80 else "flash_attention"


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
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B, S, H, D); k: (B, S, KV, D); v: (B, S, KV, Dv) with H % KV ==
    0.  Returns a new contiguous (B, S, H, Dv) tensor in q's dtype, and with
    ``return_lse`` (bf16 only) also the rows' fp32 (B, H, S) log-sum-exp
    in log2 units, as the backward takes it."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: q must be on cuda, got {dev}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, dev, q.dtype)
    B, S, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    if tuple(k.shape) != (B, S, KV, D) or tuple(v.shape) != (B, S, KV, Dv):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, {S}, KV, {D}) and "
                         f"({B}, {S}, KV, Dv)")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q/k, v) {(D, Dv)} "
                         f"not in {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} heads over {KV} kv heads")
    if not (B <= MAX_GRID_YZ and H <= MAX_GRID_YZ and S < 2 ** 31):
        raise ValueError(f"flash_attention: unsupported shape "
                         f"{tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: the log-sum-exp is saved for "
                         f"bf16 only, got {q.dtype}")
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel():
        rc = _lib.library().repro_flash_attention(
            out.data_ptr(), 0 if lse is None else lse.data_ptr(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), B, S, H, KV, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), int(window), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        _lib.check(rc, "flash_attention")
        launches[_launch_key(D, Dv)] += 1
    return (out, lse) if return_lse else out


def backward_supported(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the backward kernel takes q's dtype and head dims (one D
    for q, k and v)."""
    return (q.dtype in BWD_DTYPES and q.shape[-1] in BWD_HEAD_DIMS
            and v.shape[-1] == q.shape[-1])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` at the upstream
    gradient ``dout``, given its output ``out`` and log-sum-exp ``lse``
    (``flash_attention(..., return_lse=True)``); bf16, D = 64 or 128.
    Every operand is made contiguous; the gradients are new contiguous
    tensors in q's (k's) shape."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd: q must be on cuda, got {dev}")
    if not backward_supported(q, v):
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
    if (lse.device != dev or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, S)):
        raise ValueError(f"flash_attention_bwd: lse must be a float32 "
                         f"({B}, {H}, {S}) tensor on {dev}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    # the prep kernel fills these: lse and Delta padded to whole 64-row
    # tiles, and the zeroed fp32 dQ scratch
    s_pad = -(-S // 64) * 64
    lse_pad = torch.empty((B, H, s_pad), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse_pad)
    dq_acc = torch.empty((B, H, s_pad, D), dtype=torch.float32, device=dev)
    rc = _lib.library().repro_flash_attention_bwd(
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        lse_pad.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), B, S, H, KV, D, int(bool(causal)), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  When a
    gradient is wanted, the forward also writes the log-sum-exp and saves
    it with q, k, v and the output; under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass (and writes it again), so it
    launches twice a step."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if any(ctx.needs_input_grad[:3]):
            out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                       return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None
