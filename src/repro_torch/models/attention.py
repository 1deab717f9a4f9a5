"""Attention of ``repro/models/attention.py``: GQA (RoPE, qk-norm, sliding
window) with its KV cache, MLA (DeepSeek-V2: a compressed KV cache and
decoupled RoPE), and whisper's cross-attention to an encoder memory.

Prefill goes through ``kernels.ops.flash_attention`` where the JAX package
calls its jnp ``chunked_attention``: the hand-written Hopper kernel on the
card, the dense plain version on the host.  MLA's prefill folds the RoPE
dims into q and k (head dim 128 + 64 = 192, scale 192**-0.5) and keeps v
at its own 128, where the reference pads v to 192 for its shared kernel.
Decode attends one new token over the cache in plain PyTorch, as the JAX
package computes it outside any Pallas kernel; MLA decodes in the
weight-absorbed form, in the compressed space.  Cross-attention attends
the S decoder tokens over the M memory frames, non-causal, through the
same ``ops.flash_attention`` with keys of their own length, in prefill
and in decode alike (where S = 1 and the memory is projected again at
every step, as the reference does).

GQA's prefill takes an optional ``tp`` (``models/layers``): with a model
group, ``wq`` / ``wk`` / ``wv`` (and their biases) hold this rank's
columns, its q and kv heads, and ``wo`` the matching rows; the config is
the local one (heads over the group, ``head_dim`` pinned).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.launch import collectives
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, dense_init, rms_normalize,
                                       row_product)

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


def _ring_write(cache, news, positions):
    """Write one token's entries ``news`` (each (B, 1, ...), one a leading
    buffer of ``cache``) and its positions at each row's ring slot ``idx %
    T``, in place.  Unlike the JAX version, which returns a new cache, no
    copy of the whole cache is made per token; the returned cache is the
    same object."""
    T = cache.pos.shape[1]
    rows = torch.arange(cache.pos.shape[0], device=cache.pos.device)
    slot = (cache.idx % T).long()
    for buf, new in zip(cache, news):
        buf[rows, slot] = new[:, 0]
    cache.pos[rows, slot] = positions.to(torch.int32)
    cache.idx.add_(1)
    return cache


def cache_append(cache: KVCache, k_new, v_new, positions) -> KVCache:
    """Write one token's k/v (B, 1, KV, D) at each row's ring slot, in
    place."""
    return _ring_write(cache, (k_new, v_new), positions)


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


def _gqa_qkv(cfg: ArchConfig, p, x, positions, tp=None):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    if tp is not None:
        x = collectives.tp_copy(x, tp)
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


def gqa_prefill(cfg: ArchConfig, p, x, positions, *, causal: bool = True,
                tp=None):
    """positions: (S,), shared across the batch; they must be 0..S-1, as
    ``model.hidden_states`` builds them (see the kernel call).  ``tp``: a
    model group splitting the heads (module docstring)."""
    if tuple(positions.shape) != (x.shape[1],):
        raise ValueError(f"gqa_prefill: positions of shape "
                         f"{tuple(positions.shape)} for {x.shape[1]} tokens; "
                         f"prefill attends positions 0..S-1 only")
    q, k, v = _gqa_qkv(cfg, p, x, positions[None, :], tp)
    # the kernel's causal and window masks take the query and key
    # positions to be 0..S-1; offset positions (a chunked or continued
    # prefill) are not supported
    out = ops.flash_attention(q, k, v, causal=causal, window=cfg.attn_window)
    B, S = x.shape[:2]
    return row_product(out.reshape(B, S, -1), p["wo"], tp)


def gqa_decode(cfg: ArchConfig, p, x, cache: KVCache, cur_pos):
    """x: (B, 1, d); cur_pos: (B,) absolute position of the new token."""
    q, k, v = _gqa_qkv(cfg, p, x, cur_pos[:, None])
    cache = cache_append(cache, k, v, cur_pos)
    out = decode_attention(q, cache.k, cache.v, cache.pos, cur_pos,
                           window=cfg.attn_window)
    B = x.shape[0]
    return out.reshape(B, 1, -1) @ p["wo"], cache



# --------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV cache + decoupled RoPE
# --------------------------------------------------------------------------

class MLACache(NamedTuple):
    ckv: torch.Tensor        # (..., B, T, kv_lora)
    krope: torch.Tensor      # (..., B, T, rope_hd)
    pos: torch.Tensor        # (..., B, T) int32 absolute positions, -1 = empty
    idx: torch.Tensor        # (..., B) int32 next write slot (ring index)

    def layer(self, i: int) -> "MLACache":
        """Layer ``i`` of a layer-stacked cache, as views."""
        return MLACache(self.ckv[i], self.krope[i], self.pos[i], self.idx[i])


def init_mla_cache(batch: int, length: int, cfg: ArchConfig, dtype, *,
                   lead=(), device=None) -> MLACache:
    """kv_lora + rope_hd values a token and layer (576 at deepseek-v2-lite);
    ``lead`` stacks the cache (a leading L axis)."""
    m, lead = cfg.mla, tuple(lead)
    return MLACache(
        ckv=torch.zeros(lead + (batch, length, m.kv_lora_rank), dtype=dtype,
                        device=device),
        krope=torch.zeros(lead + (batch, length, m.rope_head_dim),
                          dtype=dtype, device=device),
        pos=torch.full(lead + (batch, length), -1, dtype=torch.int32,
                       device=device),
        idx=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


def mla_init(cfg: ArchConfig, gen: torch.Generator, *, lead=()):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    wd, lead = cfg.weight_dtype, tuple(lead)
    return {
        "wq": dense_init(gen, lead + (d, H * (m.q_head_dim
                                              + m.rope_head_dim)), wd),
        "wdkv": dense_init(gen, lead + (d, m.kv_lora_rank
                                        + m.rope_head_dim), wd),
        "wuk": dense_init(gen, lead + (m.kv_lora_rank, H * m.q_head_dim), wd),
        "wuv": dense_init(gen, lead + (m.kv_lora_rank, H * m.v_head_dim), wd),
        "wo": dense_init(gen, lead + (H * m.v_head_dim, d), wd),
    }


def _mla_q(cfg: ArchConfig, p, x, positions):
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, H, m.q_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.q_head_dim], q[..., m.q_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_kv(cfg: ArchConfig, p, x, positions):
    m = cfg.mla
    dkv = x @ p["wdkv"]
    ckv, krope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    krope = apply_rope(krope[..., None, :], positions,
                       cfg.rope_theta)[..., 0, :]
    return ckv, krope


def _mla_expand(cfg: ArchConfig, p, ckv):
    """Up-project the compressed cache to per-head k_nope and v."""
    m, H = cfg.mla, cfg.n_heads
    B, T, _ = ckv.shape
    k_nope = (ckv @ p["wuk"]).reshape(B, T, H, m.q_head_dim)
    v = (ckv @ p["wuv"]).reshape(B, T, H, m.v_head_dim)
    return k_nope, v


def mla_prefill(cfg: ArchConfig, p, x, positions):
    """positions: (S,), 0..S-1, shared across the batch (see
    ``gqa_prefill``).  q and k are ``[nope | rope]`` (the shared krope
    broadcast to every head), v its own width; attention scales by q's
    head dim, as the reference's ``chunked_attention`` on its padded v."""
    if tuple(positions.shape) != (x.shape[1],):
        raise ValueError(f"mla_prefill: positions of shape "
                         f"{tuple(positions.shape)} for {x.shape[1]} tokens; "
                         f"prefill attends positions 0..S-1 only")
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope = _mla_q(cfg, p, x, positions[None, :])
    ckv, krope = _mla_kv(cfg, p, x, positions[None, :])
    k_nope, v = _mla_expand(cfg, p, ckv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        B, S, H, m.rope_head_dim)], dim=-1)
    out = ops.flash_attention(q, k, v, causal=True, window=cfg.attn_window)
    return out.reshape(B, S, -1) @ p["wo"]


def mla_decode(cfg: ArchConfig, p, x, cache: MLACache, cur_pos):
    """Weight-absorbed MLA decode (DeepSeek-V2): q_nope goes through w_uk
    into the compressed kv_lora space, the scores and the context are
    taken there over the cache, and w_uv expands the context, so a step
    costs O(T * kv_lora) rather than O(T * H * head_dim).  Plain fp32
    einsums, as in the reference.  x: (B, 1, d); cur_pos: (B,).  The
    cache is written in place at each row's ring slot ``idx % T``."""
    m, H = cfg.mla, cfg.n_heads
    B = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, cur_pos[:, None])    # (B,1,H,.)
    cache = _ring_write(cache, _mla_kv(cfg, p, x, cur_pos[:, None]),
                        cur_pos)
    wuk = p["wuk"].reshape(m.kv_lora_rank, H, m.q_head_dim)
    q_c = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], wuk)
    scale = (m.q_head_dim + m.rope_head_dim) ** -0.5
    ckv = cache.ckv.float()
    s = (torch.einsum("bhl,btl->bht", q_c.float(), ckv)
         + torch.einsum("bhr,btr->bht", q_rope[:, 0].float(),
                        cache.krope.float())) * scale
    valid = (cache.pos >= 0) & (cache.pos <= cur_pos[:, None])
    if cfg.attn_window:
        valid &= cache.pos > (cur_pos[:, None] - cfg.attn_window)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    ctx_c = torch.einsum("bht,btl->bhl", w, ckv)
    wuv = p["wuv"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bhl,lhd->bhd", ctx_c, wuv.float()).to(x.dtype)
    return out.reshape(B, 1, H * m.v_head_dim) @ p["wo"], cache


# --------------------------------------------------------------------------
# cross-attention (whisper decoder -> encoder memory)
# --------------------------------------------------------------------------

def xattn_init(cfg: ArchConfig, gen: torch.Generator, *, lead=()):
    """wq, wk, wv, wo without biases; wk and wv take the memory's width
    (``encoder.d_embed``, d_model when 0)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    d_mem = cfg.encoder.d_embed or d
    wd, lead = cfg.weight_dtype, tuple(lead)
    return {"wq": dense_init(gen, lead + (d, H * hd), wd),
            "wk": dense_init(gen, lead + (d_mem, H * hd), wd),
            "wv": dense_init(gen, lead + (d_mem, H * hd), wd),
            "wo": dense_init(gen, lead + (H * hd, d), wd)}


def xattn_apply(cfg: ArchConfig, p, x, memory):
    """x: (B, S, d); memory: (B, M, d_embed).  Every token attends every
    frame (no mask): ``ops.flash_attention`` with S queries over M keys,
    non-causal, counted as a cross-attention whether or not M == S."""
    B, S, _ = x.shape
    M = memory.shape[1]
    H, hd = cfg.n_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (memory @ p["wk"]).reshape(B, M, H, hd)
    v = (memory @ p["wv"]).reshape(B, M, H, hd)
    out = ops.flash_attention(q, k, v, causal=False, cross=True)
    return out.reshape(B, S, -1) @ p["wo"]
