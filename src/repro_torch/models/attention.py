"""GQA self-attention (RoPE, qk-norm, sliding window) and its KV cache
(the GQA part of ``repro/models/attention.py``).

Prefill goes through ``kernels.ops.flash_attention`` where the JAX package
calls its jnp ``chunked_attention``: the hand-written Hopper kernel on the
card, the dense plain version on the host.  Decode attends one new token
over the cache in plain PyTorch, as the JAX package computes it outside
any Pallas kernel.  MLA and cross-attention are not ported yet
(``models/transformer`` refuses the MLA kind and the encdec pattern).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_normalize

NEG_INF = -1e30


def decode_attention(q, k_cache, v_cache, kv_pos, cur_pos, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffered) KV cache.

    q: (B, 1, H, D); k/v_cache: (B, T, KV, D); kv_pos: (B, T) absolute
    positions (-1 for unwritten slots); cur_pos: (B,) current position.
    Scores in fp32; the probabilities are rounded to the cache dtype
    before the PV product, as in the JAX version."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    valid = (kv_pos >= 0) & (kv_pos <= cur_pos[:, None])
    if window:
        valid &= kv_pos > (cur_pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# KV cache
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (..., B, T, KV, D)
    v: torch.Tensor          # (..., B, T, KV, D)
    pos: torch.Tensor        # (..., B, T) int32 absolute positions, -1 = empty
    idx: torch.Tensor        # (..., B) int32 next write slot (ring index)

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a layer-stacked cache, as views."""
        return KVCache(self.k[i], self.v[i], self.pos[i], self.idx[i])


def init_kv_cache(batch: int, length: int, n_kv: int, head_dim: int, dtype,
                  *, lead=(), device=None) -> KVCache:
    """``lead`` stacks the cache (a leading L axis)."""
    lead = tuple(lead)
    return KVCache(
        k=torch.zeros(lead + (batch, length, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros(lead + (batch, length, n_kv, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full(lead + (batch, length), -1, dtype=torch.int32,
                       device=device),
        idx=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


def cache_append(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """Write one token's k/v at each row's ring slot ``idx % T``.
    k_new: (B, 1, KV, D).  Unlike the JAX version, which returns a new
    cache, the buffers are written in place (no copy of the whole cache per
    token); the returned cache is the same object."""
    T = cache.k.shape[1]
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    slot = (cache.idx % T).long()
    cache.k[rows, slot] = k_new[:, 0]
    cache.v[rows, slot] = v_new[:, 0]
    cache.pos[rows, slot] = positions.to(torch.int32)
    cache.idx.add_(1)
    return cache


# --------------------------------------------------------------------------
# GQA self-attention
# --------------------------------------------------------------------------

def gqa_init(cfg: ArchConfig, gen: torch.Generator, *, lead=()):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    wd, lead = cfg.weight_dtype, tuple(lead)
    p = {"wq": dense_init(gen, lead + (d, H * hd), wd),
         "wk": dense_init(gen, lead + (d, KV * hd), wd),
         "wv": dense_init(gen, lead + (d, KV * hd), wd),
         "wo": dense_init(gen, lead + (H * hd, d), wd)}
    if cfg.attn_bias:
        for name, n in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros(lead + (n * hd,), dtype=wd,
                                  device=gen.device)
    return p


def _gqa_qkv(cfg: ArchConfig, p, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q, k = rms_normalize(q), rms_normalize(k)
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(cfg: ArchConfig, p, x, positions, *, causal: bool = True):
    """positions: (S,), shared across the batch; they must be 0..S-1, as
    ``model.hidden_states`` builds them (see the kernel call)."""
    if tuple(positions.shape) != (x.shape[1],):
        raise ValueError(f"gqa_prefill: positions of shape "
                         f"{tuple(positions.shape)} for {x.shape[1]} tokens; "
                         f"prefill attends positions 0..S-1 only")
    q, k, v = _gqa_qkv(cfg, p, x, positions[None, :])
    # the kernel's causal and window masks take the query and key
    # positions to be 0..S-1; offset positions (a chunked or continued
    # prefill) are not supported
    out = ops.flash_attention(q, k, v, causal=causal, window=cfg.attn_window)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p["wo"]


def gqa_decode(cfg: ArchConfig, p, x, cache: KVCache, cur_pos):
    """x: (B, 1, d); cur_pos: (B,) absolute position of the new token."""
    q, k, v = _gqa_qkv(cfg, p, x, cur_pos[:, None])
    cache = cache_append(cache, k, v, cur_pos)
    out = decode_attention(q, cache.k, cache.v, cache.pos, cur_pos,
                           window=cfg.attn_window)
    B = x.shape[0]
    return out.reshape(B, 1, -1) @ p["wo"], cache

