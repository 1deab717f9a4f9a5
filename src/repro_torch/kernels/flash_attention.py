"""Flash attention on the card: the wrapper around the CUDA kernel
``csrc/flash_attention.cu``, the port's counterpart of the Pallas kernel
``repro.kernels.flash_attention.flash_attention``.

    out[b, s, h, :] = softmax_t(q[b, s, h] . k[b, t, h // G] * D**-0.5 + mask)
                      @ v[b, t, h // G]

with ``t <= s`` when causal, ``t > s - window`` when ``window > 0``; fp32
scores and accumulation, the output in q's dtype.  q is (B, S, H, D), k is
(B, T, KV, D) and v (B, T, KV, Dv), all bf16 or all fp32, read in place
through their strides: the last axis must be contiguous and, for bf16,
every row must start on 16 bytes (what the TMA copies need).  The keys
are the queries' positions (T == S) for self-attention; whisper's
cross-attention gives them a length of their own (S decoder tokens over T
encoder frames), which the kernel takes with ``causal=False`` and
``window=0`` only, the reference's ``xattn_apply``.  (D, Dv) is (32, 32),
(64, 64), zamba2-2.7b's (80, 80), phi-3-vision's (96, 96), (128, 128),
MLA's (192, 128) (deepseek-v2-lite's prefill folds 64 RoPE dims into q
and k and keeps v at 128, where the reference zero-pads v to 192) or
nemotron-4-340b's (192, 192) (d_model 18432 over 96 heads, q, k and v
alike) (``HEAD_DIMS``).  ``forward_route`` names the kernel a call runs:

- ``tma_wgmma``: bf16 at (128, 128), MLA's (192, 128), (192, 192), (96,
  96), (80, 80) and (64, 64), one warp-specialised kernel (TMA copies into
  an mbarrier ring, wgmma products; a q/k row is one to three 128-byte
  boxes, the second of an 80- or 96-wide row zero past its 16 or 32
  columns, and PV a wgmma m64n<Dv>k16; blocks ordered in groups of 16 (b,
  h) pairs, so that the blocks in flight share K/V in the L2; a 2-stage
  ring of 128-key K/V tiles, of 64-key tiles at (192, 192), where 128
  would pass the shared memory a block may take);
- ``split_keys``: bf16 at (64, 64) with at most ``SPLIT_MAX_QUERIES``
  non-causal queries and no window (whisper-tiny's decode step: one
  query over 1500 encoder frames): the keys of each (b, h) cut into
  ``split_plan``'s ranges, a block of 4 warps a range on the FMA units,
  and the last block of a (b, h) merges the ranges' fp32 (m, l, acc)
  partials, all in one launch.  The partials, (B, H, S, splits, 66) fp32,
  are allocated with the call's output; the (B * H) int32 arrival
  counters are a buffer kept per device and stream, zeroed once, which
  the kernel leaves at 0;
- ``mma_sync``: bf16 at D = 32 (test shapes, the reduced SSM and MLA
  configs), the mma.sync kernel;
- ``fma``: fp32, the FMA units.

The probabilities stay fp32, as bf16 hi + lo parts through the tensor
cores (the split-key kernel multiplies them on the FMA units), so the
output agrees with the plain version to about one bf16 ulp elementwise
(a single bf16 P would not, on outputs near zero).

With ``return_lse=True`` the bf16 forward also returns each row's
log-sum-exp, the fp32 (B, H, S) ``log2 sum_t 2^(score_t * D**-0.5 *
log2 e)`` over the live keys (``kernels/ref.attention_lse_ref``), written in
the kernel's epilogue; without it the kernel stores nothing more.

The backward, ``csrc/flash_attention_bwd.cu``, has no TPU counterpart
(the JAX package differentiates its jnp attention): dQ, dK and dV of the
same function for bf16 q / k / v with D = 64, 80 (zamba2-2.7b), 96
(phi-3-vision-4.2b) or 128 and T == S (``BWD_HEAD_DIMS``), and at D = 64
also with keys of their own length (whisper-tiny's cross-attention, S
tokens over T encoder frames, non-causal: the key tiles, their masks and
dK / dV on T, the query side on S), from the forward's output and saved
lse.  It does 5 products a live (query, key)
pair (S, dP, dV, dK, dQ) in one fused kernel a (key tile, KV head, batch
row): at D = 128, 96 and 80 one template of two wgmma warpgroups of 64
keys each, fed by TMA through a 2-stage ring, a row two 64-column boxes
(zero past D at 80 and 96), dV and dK as wgmma m64n<D>k16 and dQ split
between the warpgroups by box (register budget of a thread at 128: 128
fp32 for the dK and dV accumulators across the loop, D at 80 and 96, 32
for half a tile's S^T and dP^T, 32 for the dQ share; 236 in all with
addressing, under the 255 of a 256-thread block, see the source); at D =
64 mma.sync with cp.async double buffering.  dQ of the key tiles sums
into an fp32 scratch by bulk reduce-adds in no fixed order, so it may
differ in its last bits from run to run.  ``FlashAttention`` ties the two into one
``torch.autograd.Function``, which is what ``kernels/ops.flash_attention``
calls on CUDA tensors.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref.flash_attention_ref``.  ``launches``
counts launches: one a forward call (under ``flash_attention_cross``
for a caller's cross-attention, ``cross=True``, or keys of their own
length, T != S; else ``flash_attention_mla`` at MLA's head dims and the
key of ``BY_HEAD_DIM`` at 80, 96 and 192), and one a backward call (which runs the backward's
three kernels: prep, the fused kernel, the dQ pass) under
``flash_attention_bwd``, counted under ``flash_attention_bwd_cross`` as
well where the keys have a length of their own (T != S).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (96, 96), (128, 128),
             (192, 128), (192, 192))                       # (D, Dv)
DTYPES = (torch.bfloat16, torch.float32)
BWD_HEAD_DIMS = (64, 80, 96, 128)
BWD_DTYPES = (torch.bfloat16,)
BWD_CROSS_HEAD_DIM = 64     # keys of their own length: whisper-tiny's D
MAX_GRID_YZ = 65535     # H on gridDim.y, B on gridDim.z
# the split-key route: queries a call at most (whisper's decode step has
# 1), keys a range at most while the card has room for more blocks (one
# 32-key group for each of a block's 4 warps), and the kernel's key group
# (a range is a whole number of groups)
SPLIT_MAX_QUERIES = 4
SPLIT_KEYS = 128
SPLIT_GROUP = 32
SPLIT_PART = 66         # fp32 a partial: acc[64], m, l

launches: Dict[str, int] = {"flash_attention": 0, "flash_attention_mla": 0,
                            "flash_attention_d80": 0,
                            "flash_attention_d96": 0,
                            "flash_attention_d192": 0,
                            "flash_attention_cross": 0,
                            "flash_attention_bwd": 0,
                            "flash_attention_bwd_cross": 0}
# head dims whose forward launches have a count of their own: zamba2's,
# phi-3-vision's and nemotron-4-340b's
BY_HEAD_DIM = {80: "flash_attention_d80", 96: "flash_attention_d96",
               192: "flash_attention_d192"}


def _launch_key(D: int, Dv: int, cross: bool = False) -> str:
    """The count a forward launch at head dims (D, Dv) adds to; ``cross``:
    a cross-attention (keys that are not the queries')."""
    if cross:
        return "flash_attention_cross"
    if D != Dv:
        return "flash_attention_mla"
    return BY_HEAD_DIM.get(D, "flash_attention")


def forward_route(dtype: torch.dtype, D: int, Dv: int, S: int,
                  causal: bool, window: int) -> str:
    """The kernel a forward call runs: ``tma_wgmma``, ``split_keys``,
    ``mma_sync`` or ``fma`` (see the module docstring)."""
    if dtype != torch.bfloat16:
        return "fma"
    if D == 32:
        return "mma_sync"
    if (D == Dv == 64 and not causal and not window
            and S <= SPLIT_MAX_QUERIES):
        return "split_keys"
    return "tma_wgmma"


def split_plan(B: int, H: int, S: int, T: int,
               resident: int) -> Tuple[int, int]:
    """(splits, chunk) for S queries over T keys at B x H (batch row,
    head) pairs on a card that holds ``resident`` of the kernel's blocks
    at once (``split_resident``): range j holds keys [j * chunk, min(T,
    (j + 1) * chunk)), so the ranges cover [0, T) and none is empty.  Past
    ``SPLIT_MAX_QUERIES`` queries (the prefill shapes) one range of all T
    keys; else one range a ``SPLIT_KEYS`` keys, as far as the card holds
    the blocks at once (so that they run in one wave), the keys then
    shared out evenly in whole ``SPLIT_GROUP``-key groups.  whisper-tiny's
    decode step (B=8, H=6, S=1, T=1500) on an H100 (132 SMs, 6 blocks of
    the one-query instance an SM): 12 ranges of 128 keys, 576 blocks.

    The cut-off of four queries is measured (``tools/attn_times.py
    --split-cutoff``, device time at B=8, H=6, T=1500 on an H100, with
    this plan): the split-key kernel took 0.0099, 0.0116 and 0.0151 ms at
    1, 2 and 4 queries (12, 5 and 5 ranges), 0.0219 and 0.0371 at 8 and
    16, the TMA + wgmma kernel 0.0232-0.0233 at each (``PERF.md`` §6); past
    4 the lead is 6% at most and whisper's decode step has 1 query."""
    if S > SPLIT_MAX_QUERIES:
        return 1, T
    room = max(1, resident // max(1, B * H))
    splits = max(1, min(-(-T // SPLIT_KEYS), room))
    chunk = -(-T // splits)
    chunk = -(-chunk // SPLIT_GROUP) * SPLIT_GROUP
    return -(-T // chunk), chunk


_RESIDENT: Dict[Tuple[int, int], int] = {}


def split_resident(dev: torch.device, S: int) -> int:
    """The split-key kernel's blocks for S queries that ``dev`` holds at
    once: its SMs times the instance's occupancy an SM (registers)."""
    key = (dev.index, S)
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        _lib.check(_lib.library().repro_flash_attention_split_occupancy(
            S, ctypes.byref(per_sm)), "flash_attention split occupancy")
        _RESIDENT[key] = per_sm.value * torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _RESIDENT[key]


# (device index, stream handle) -> int32 arrival counters of the
# split-key kernel, zero between its launches on that stream
_SPLIT_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _split_counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _SPLIT_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _SPLIT_COUNTERS[key] = buf
    return buf


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
                    return_lse: bool = False, cross: bool = False):
    """q: (B, S, H, D); k: (B, T, KV, D); v: (B, T, KV, Dv) with H % KV ==
    0, and T != S only with ``causal=False`` and ``window=0``.  ``cross``:
    the caller's cross-attention (counted as such whatever T is; takes
    ``causal=False`` and ``window=0`` too).  Returns a
    new contiguous (B, S, H, Dv) tensor in q's dtype, and with
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
    T, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if tuple(k.shape) != (B, T, KV, D) or tuple(v.shape) != (B, T, KV, Dv):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be ({B}, T, KV, {D}) and "
                         f"({B}, T, KV, Dv)")
    cross = cross or T != S
    if cross and (causal or window):
        raise ValueError(f"flash_attention: {T} keys for {S} queries take "
                         f"causal=False and window=0 (cross-attention), got "
                         f"causal={causal}, window={window}")
    if T < 1 <= S:
        raise ValueError(f"flash_attention: no keys for {S} queries")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q/k, v) {(D, Dv)} "
                         f"not in {HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} heads over {KV} kv heads")
    if not (B <= MAX_GRID_YZ and H <= MAX_GRID_YZ and S < 2 ** 31
            and T < 2 ** 31):
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        lse_ptr = 0 if lse is None else lse.data_ptr()
        strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        if forward_route(q.dtype, D, Dv, S, causal, window) == "split_keys":
            splits, chunk = split_plan(B, H, S, T, split_resident(dev, S))
            part = torch.empty((B, H, S, splits, SPLIT_PART),
                               dtype=torch.float32, device=dev)
            rc = _lib.library().repro_flash_attention_split(
                out.data_ptr(), lse_ptr, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), part.data_ptr(),
                _split_counters(dev, stream, B * H).data_ptr(), B, S, T, H,
                KV, splits, chunk, *strides, stream)
        else:
            rc = _lib.library().repro_flash_attention(
                out.data_ptr(), lse_ptr, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), B, S, T, H, KV, D, Dv, *strides,
                int(bool(causal)), int(window),
                int(q.dtype == torch.bfloat16), stream)
        _lib.check(rc, "flash_attention")
        launches[_launch_key(D, Dv, cross)] += 1
    return (out, lse) if return_lse else out


def backward_supported(q: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the backward kernel takes q's dtype and head dims (one D
    for q, k and v) and v's length: the queries' own, or at D =
    ``BWD_CROSS_HEAD_DIM`` any (a cross-attention, non-causal)."""
    D = q.shape[-1]
    return (q.dtype in BWD_DTYPES and D in BWD_HEAD_DIMS
            and v.shape[-1] == D
            and (v.shape[1] == q.shape[1] or D == BWD_CROSS_HEAD_DIM))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` at the upstream
    gradient ``dout``, given its output ``out`` and log-sum-exp ``lse``
    (``flash_attention(..., return_lse=True)``); bf16, D in
    ``BWD_HEAD_DIMS`` (64, 80, 96, 128); k and v (B, T, KV, D) with T ==
    S, or at D = 64 any T with ``causal=False`` and ``window=0``.  Every
    operand is made contiguous; the gradients are new contiguous tensors
    in q's (k's) shape."""
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
    T, KV = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, T, KV, D) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    if KV < 1 or H % KV or not (B <= MAX_GRID_YZ and H <= MAX_GRID_YZ):
        raise ValueError(f"flash_attention_bwd: unsupported heads {H} / {KV} "
                         f"or batch {B}")
    if window < 0:
        raise ValueError(f"flash_attention_bwd: window {window} < 0")
    if T != S and (causal or window):
        raise ValueError(f"flash_attention_bwd: {T} keys for {S} queries "
                         f"take causal=False and window=0, got "
                         f"causal={causal}, window={window}")
    if T < 1 <= S:
        raise ValueError(f"flash_attention_bwd: no keys for {S} queries")
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
        dout.data_ptr(), B, S, T, H, KV, D, int(bool(causal)), int(window),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    if T != S:
        launches["flash_attention_bwd_cross"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  When a
    gradient is wanted, the forward also writes the log-sum-exp and saves
    it with q, k, v and the output; under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass (and writes it again), so it
    launches twice a step.  ``cross``: the caller's cross-attention, as
    ``flash_attention`` counts it.  A cross-attention of at most
    ``SPLIT_MAX_QUERIES`` queries runs the split-key forward, whose lse is
    the same log-sum-exp (held to the plain version in phase 2b)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                cross: bool = False):
        kw = dict(causal=causal, window=window, cross=cross)
        if any(ctx.needs_input_grad[:3]):
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out = flash_attention(q, k, v, **kw)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None
