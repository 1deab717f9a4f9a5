"""Mamba-2 block via the chunked SSD (state-space duality) formulation
(``repro/models/ssm.py``), forward only.

State update per head: h_t = exp(dt·A)·h_{t-1} + dt·B_t ⊗ x_t ;  y_t =
C_t·h_t + D·x_t  (scalar A per head, one group of B and C shared by the
heads).  The JAX package has no Pallas kernel here, and neither does the
port: prefill and decode are plain PyTorch on the card and on the host
alike.

Prefill evaluates the recurrence chunk-parallel, as the reference does:
the intra-chunk terms are masked (L, L) products, batched over (batch,
head, chunk).  Where the reference carries the state from chunk to chunk
with a ``lax.scan``, the port sums the same carry in closed form over
chunks (the Mamba-2 paper's minimal SSD, arXiv:2405.21060): one masked
(nc, nc) decay matrix per (batch, head) and one product, so a call makes
a fixed number of launches whatever the sequence length.  It is the same
sum taken in another order (the chunk decays are summed by a masked
cumulative sum, not multiplied one by one).

Decode keeps an O(1) cache (the conv window, the SSM state) and updates
it in place, where JAX returns a new one; like the other caches it is
stacked on leading layer axes, with ``.layer(i)`` giving views.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (..., B, conv_dim - 1, conv_ch) input window
    state: torch.Tensor   # (..., B, H, N, P) fp32 SSM state
    pos: torch.Tensor     # (..., B) int32 step count

    def layer(self, i: int) -> "MambaCache":
        """Layer ``i`` of a layer-stacked cache, as views."""
        return MambaCache(self.conv[i], self.state[i], self.pos[i])


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.state_dim            # x, B, C all convolved
    return d_inner, n_heads, conv_ch


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, *, lead=(),
                     device=None) -> MambaCache:
    """``lead`` stacks the cache (leading layer axes)."""
    s, lead = cfg.ssm, tuple(lead)
    _, H, conv_ch = _dims(cfg)
    return MambaCache(
        conv=torch.zeros(lead + (batch, s.conv_dim - 1, conv_ch),
                         dtype=dtype, device=device),
        state=torch.zeros(lead + (batch, H, s.state_dim, s.head_dim),
                          dtype=torch.float32, device=device),
        pos=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


def mamba_init(cfg: ArchConfig, gen: torch.Generator, *, lead=()):
    s, d = cfg.ssm, cfg.d_model
    d_inner, H, conv_ch = _dims(cfg)
    wd, lead, dev = cfg.weight_dtype, tuple(lead), gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    u = torch.empty(lead + (H,), **f32).uniform_(math.log(1e-3),
                                                math.log(1e-1), generator=gen)
    return {
        # projections: [z (gate), x, B, C, dt]
        "w_in": dense_init(gen, lead + (d, 2 * d_inner + 2 * s.state_dim + H),
                           wd),
        "conv_w": dense_init(gen, lead + (s.conv_dim, conv_ch), wd,
                             scale=0.5),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=wd, device=dev),
        "A_log": a_log.expand(lead + (H,)).contiguous(),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "norm_scale": torch.ones(lead + (d_inner,), dtype=wd, device=dev),
        "w_out": dense_init(gen, lead + (d_inner, d), wd),
    }


def _split_proj(cfg: ArchConfig, p, x):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * s.state_dim]
    dt_raw = zxbcdt[..., -H:]
    return z, xbc, dt_raw


def _causal_conv(p, xbc, conv_dim: int):
    """Depthwise causal conv over (B, S, C) with window ``conv_dim``: the
    products and their running sum in the weights' dtype, in the
    reference's order, then the bias, then silu in fp32."""
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, conv_dim - 1, 0))
    out = pad[:, 0:S] * p["conv_w"][0]
    for i in range(1, conv_dim):
        out = out + pad[:, i:i + S] * p["conv_w"][i]
    return F.silu((out + p["conv_b"]).float()).to(xbc.dtype)


def _gated_out(cfg, p, y, z, B, S):
    d_inner, _, _ = _dims(cfg)
    y = y.reshape(B, S, d_inner)
    yf = y.float()
    ms = yf.square().mean(dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(ms + 1e-6)).to(y.dtype) * p["norm_scale"]
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ p["w_out"]


def _chunk_decay(last: torch.Tensor) -> torch.Tensor:
    """(..., nc) chunk log-decays -> (..., nc, nc) weights of chunk c'
    state in chunk c's start state: exp(sum of last[c''] for c' < c'' <
    c) below the diagonal, 0 elsewhere.  The sums are a masked cumulative
    sum (the minimal SSD's ``segsum``), not differences of running
    totals, so no precision is lost to a long sequence's large totals."""
    nc = last.shape[-1]
    dev = last.device
    # rows c, columns c': terms last[c''] for c' < c'' < c
    k = torch.arange(nc, device=dev)
    rep = last[..., None, :].expand(last.shape + (nc,)).transpose(-1, -2)
    rep = rep.masked_fill(k[:, None] <= k[None, :], 0.0)   # keep c'' > c'
    seg = rep.cumsum(dim=-2)        # [c'', c'] = sum of last over (c', c'']
    seg = F.pad(seg[..., :-1, :], (0, 0, 1, 0))            # row c: up to c-1
    return torch.exp(seg).masked_fill(k[:, None] <= k[None, :], 0.0)


def mamba_prefill(cfg: ArchConfig, p, x):
    """x: (B, S, d_model) -> (B, S, d_model).  Chunked SSD, laid out per
    (batch, head, chunk) so that each sum over a chunk's positions or
    state is one batched product; fp32 as in the reference."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    B, S, _ = x.shape
    N, P, L = s.state_dim, s.head_dim, s.chunk_size

    z, xbc, dt_raw = _split_proj(cfg, p, x)
    xbc = _causal_conv(p, xbc, s.conv_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])            # (B,S,H)
    dA = dt * -torch.exp(p["A_log"])                          # log-decay

    # pad to a chunk multiple
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
    xbc = xbc.view(B, nc, L, -1)
    # (B, H, nc, L, P) fp32 inputs; B and C (B, nc, L, N) shared by heads
    xs = torch.empty((B, H, nc, L, P), dtype=torch.float32, device=x.device)
    xs.copy_(xbc[..., :d_inner].unflatten(-1, (H, P)).permute(0, 3, 1, 2, 4))
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    dt = dt.view(B, nc, L, H).permute(0, 3, 1, 2)              # (B,H,nc,L)
    cum = dA.view(B, nc, L, H).permute(0, 3, 1, 2).cumsum(dim=-1)

    # intra-chunk: y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    # (C . B in the activations' dtype, as the reference's einsum)
    scores = (Cm @ Bm.transpose(-1, -2)).float()              # (B,nc,L,L)
    # (out of place: under ``torch.utils.checkpoint`` an in-place update
    # of a tensor saved for the backward goes undetected)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    w = cum[..., :, None] - cum[..., None, :]                 # (B,H,nc,L,L)
    w = torch.exp(w.masked_fill(~causal, float("-inf")))
    w = w * scores[:, None] * dt[..., None, :]
    y = w @ xs                                                # (B,H,nc,L,P)
    del w, scores

    # chunk-final states: sum_j exp(cum_L - cum_j) dt_j B_j ⊗ x_j
    to_end = torch.exp(cum[..., -1:] - cum) * dt              # (B,H,nc,L)
    states = Bm.float().transpose(-1, -2)[:, None] @ (xs * to_end[..., None])
    # each chunk's start state from every earlier chunk's, in closed form
    decay = _chunk_decay(cum[..., -1])                        # (B,H,nc,nc)
    h_prev = (decay @ states.flatten(-2)).view(B, H, nc, N, P)
    del states

    # inter-chunk: C_i . (decay from the chunk's start) . h_prev, then D x
    y += torch.exp(cum)[..., None] * (Cm.float()[:, None] @ h_prev)
    y += p["D"][None, :, None, None, None] * xs
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, P)[:, :S]
    return _gated_out(cfg, p, y.to(x.dtype), z, B, S)


def mamba_decode(cfg: ArchConfig, p, x, cache: MambaCache):
    """x: (B, 1, d_model); O(1) state update.  Returns (out, cache) with
    the cache updated in place."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    B = x.shape[0]
    N, P = s.state_dim, s.head_dim

    z, xbc_new, dt_raw = _split_proj(cfg, p, x)               # (B,1,·)
    # rolling conv window: a new tensor, so the cache's shift below copies
    # between distinct buffers
    win = torch.cat([cache.conv, xbc_new], dim=1)             # (B,conv_dim,C)
    # the reference's einsum: fp32 products and sum, one rounding
    conv = (win.float() * p["conv_w"].float()).sum(dim=1).to(win.dtype)
    xbc = F.silu((conv + p["conv_b"]).float()).to(x.dtype)    # (B,C)

    xs = xbc[:, :d_inner].reshape(B, H, P).float()
    Bm = xbc[:, d_inner:d_inner + N].float()
    Cm = xbc[:, d_inner + N:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])      # (B,H)
    dec = torch.exp(dt * -torch.exp(p["A_log"]))              # (B,H)

    state = cache.state.mul_(dec[..., None, None]).add_(
        dt[..., None, None] * Bm[:, None, :, None] * xs[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cm, state) + p["D"][None, :, None] * xs
    out = _gated_out(cfg, p, y.to(x.dtype)[:, None], z, B, 1)
    cache.conv.copy_(win[:, 1:])
    cache.pos.add_(1)
    return out, cache
