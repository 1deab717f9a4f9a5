"""Block assembly (``repro/models/transformer.py``) for the ``decoder``
pattern (attention + feed-forward residual sub-blocks), whisper's
``encdec`` pattern (self-attention, cross-attention to the encoder
memory, feed-forward), the Mamba-2 ``mamba`` pattern, the xLSTM ``mlstm``
and ``slstm`` patterns and Zamba2's ``zamba_super`` hybrid: layer params
stacked on a leading L axis as
``stack_init`` builds them in JAX, applied by a Python loop over that
axis where JAX scans.  The attention is GQA or MLA (``cfg.attn_impl``), the
feed-forward an MLP or, with ``cfg.moe``, the MoE layer, whose load-balance
loss the stack sums layer by layer as the reference's scan carries it.
Under autograd (training) each stacked leaf is unbound once a forward, so
the backward stacks each leaf's layer gradients once instead of building a
zero (L, ...) gradient a layer, and each layer is recomputed in the
backward (``torch.utils.checkpoint``), the reference's ``jax.checkpoint``;
no-grad prefill indexes the layers as views.  The per-layer decode caches
(the KV cache, the MLA cache, the Mamba cache, the mLSTM and sLSTM states)
are stacked on L too and updated in place.  The cross-attention keeps no
cache: ``memory`` (B, M, d_embed), threaded through every layer in
prefill and decode, is projected again at each call, as in the
reference.

``zamba_super`` (repeat n) applies one ``decoder`` layer whose weights all
n applications share (``params["shared_attn"]``), each application
followed by ``cfg.shared_every`` Mamba layers: their params stacked on
(n, shared_every), the shared block's KV caches on (n,), the Mamba caches
on (n, shared_every), as in the JAX tree.

The prefill functions pass an optional ``tp`` (a model group splitting
the ``decoder`` layer's attention heads and MLP, ``models/layers``) down
to the sub-blocks; None is the unsplit model.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (mlp_apply, mlp_init, norm_apply,
                                       norm_init)

PATTERNS = {"decoder": ("attn", "ffn"),
            "encdec": ("attn", "xattn", "ffn"),
            "mamba": ("mamba",),
            "mlstm": ("mlstm",),
            "slstm": ("slstm",)}
KINDS = ("attn", "ffn", "xattn", "mamba", "mlstm", "slstm")
_INIT = {"xattn": attn_mod.xattn_init, "mamba": ssm_mod.mamba_init,
         "mlstm": xlstm_mod.mlstm_init, "slstm": xlstm_mod.slstm_init}
_PREFILL = {"mamba": ssm_mod.mamba_prefill,
            "mlstm": xlstm_mod.mlstm_prefill,
            "slstm": xlstm_mod.slstm_prefill}
_STATE = {"mamba": lambda cfg, batch, **kw: ssm_mod.init_mamba_cache(
              cfg, batch, cfg.activation_dtype, **kw),
          "mlstm": xlstm_mod.init_mlstm_state,
          "slstm": xlstm_mod.init_slstm_state}
_DECODE = {"mamba": ssm_mod.mamba_decode, "mlstm": xlstm_mod.mlstm_decode,
           "slstm": xlstm_mod.slstm_decode}


def _check(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; known: {KINDS}")


def _index(tree, i: int):
    """Layer ``i`` of a layer-stacked params dict, as views."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a layer-stacked params dict, one ``unbind`` a
    leaf (whose backward is one stack)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(tree.unbind(0))


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


# --------------------------------------------------------------------------
# sub-block init / apply
# --------------------------------------------------------------------------

def sub_init(cfg: ArchConfig, kind: str, gen: torch.Generator, *, lead=()):
    _check(kind)
    if kind == "attn":
        init = attn_mod.mla_init if cfg.attn_impl == "mla" else \
            attn_mod.gqa_init
    elif kind == "ffn":
        init = moe_mod.moe_init if cfg.moe is not None else mlp_init
    else:
        init = _INIT[kind]
    return {"norm": norm_init(cfg, cfg.d_model, lead=lead, device=gen.device),
            "inner": init(cfg, gen, lead=lead)}


def sub_prefill(cfg: ArchConfig, kind: str, p, x, positions, memory=None,
                tp=None):
    """Returns (residual delta, aux loss): the MoE layer's load-balance
    loss, None for every other kind (the reference's zero).  ``memory``
    (B, M, d_embed) is what ``xattn`` attends; ``tp`` splits GQA and the
    MLP over a model group."""
    _check(kind)
    xn = norm_apply(cfg, p["norm"], x)
    if kind == "attn":
        if cfg.attn_impl == "mla":
            return attn_mod.mla_prefill(cfg, p["inner"], xn, positions), None
        return attn_mod.gqa_prefill(cfg, p["inner"], xn, positions,
                                    tp=tp), None
    if kind == "xattn":
        return attn_mod.xattn_apply(cfg, p["inner"], xn, memory), None
    if kind in _PREFILL:
        return _PREFILL[kind](cfg, p["inner"], xn), None
    if cfg.moe is not None:
        return moe_mod.moe_apply(cfg, p["inner"], xn)
    return mlp_apply(cfg, p["inner"], xn, tp), None


def sub_init_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int, *,
                   lead=(), device=None):
    _check(kind)
    if kind in _STATE:
        return _STATE[kind](cfg, batch, lead=lead, device=device)
    if kind != "attn":       # ffn, xattn: no cache
        return None
    length = (min(cache_len, cfg.attn_window) if cfg.attn_window
              else cache_len)
    if cfg.attn_impl == "mla":
        return attn_mod.init_mla_cache(batch, length, cfg,
                                       cfg.activation_dtype, lead=lead,
                                       device=device)
    return attn_mod.init_kv_cache(batch, length, cfg.n_kv_heads,
                                  cfg.head_dim_, cfg.activation_dtype,
                                  lead=lead, device=device)


def sub_decode(cfg: ArchConfig, kind: str, p, x, cache, cur_pos,
               memory=None):
    """Returns (residual delta, cache); the cache is updated in place.  The
    MoE layer routes the step's B tokens as one group, and its aux loss is
    dropped, as in the reference.  ``xattn`` attends ``memory``, projected
    again at every step."""
    _check(kind)
    xn = norm_apply(cfg, p["norm"], x)
    if kind == "attn":
        if cfg.attn_impl == "mla":
            return attn_mod.mla_decode(cfg, p["inner"], xn, cache, cur_pos)
        return attn_mod.gqa_decode(cfg, p["inner"], xn, cache, cur_pos)
    if kind == "xattn":
        return attn_mod.xattn_apply(cfg, p["inner"], xn, memory), None
    if kind in _DECODE:
        return _DECODE[kind](cfg, p["inner"], xn, cache)
    if cfg.moe is not None:
        return moe_mod.moe_apply(cfg, p["inner"], xn)[0], None
    return mlp_apply(cfg, p["inner"], xn), None


# --------------------------------------------------------------------------
# layer (pattern) level
# --------------------------------------------------------------------------

def _kinds(pattern: str):
    if pattern not in PATTERNS:
        raise ValueError(f"unknown layer pattern {pattern!r}; known: "
                         f"{tuple(PATTERNS)}")
    return PATTERNS[pattern]


def layer_init(cfg: ArchConfig, pattern: str, gen, *, lead=()):
    return {k: sub_init(cfg, k, gen, lead=lead) for k in _kinds(pattern)}


def layer_prefill(cfg, pattern, p, x, positions, memory=None, tp=None):
    """Returns (x, the layer's aux loss, or None without MoE)."""
    aux = None
    for kind in _kinds(pattern):
        delta, a = sub_prefill(cfg, kind, p[kind], x, positions, memory, tp)
        x = x + delta
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def layer_init_cache(cfg, pattern, batch, cache_len, *, lead=(),
                     device=None):
    caches = {k: sub_init_cache(cfg, k, batch, cache_len, lead=lead,
                                device=device) for k in _kinds(pattern)}
    return {k: c for k, c in caches.items() if c is not None}


def layer_decode(cfg, pattern, p, x, cache, cur_pos, memory=None):
    for kind in _kinds(pattern):
        delta, _ = sub_decode(cfg, kind, p[kind], x, cache.get(kind),
                              cur_pos, memory)
        x = x + delta
    return x


# --------------------------------------------------------------------------
# stack level
# --------------------------------------------------------------------------

def stack_init(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """{"segments": [per-segment layer params stacked on a leading L
    axis]}, and with ``zamba_super`` its Mamba layers stacked on (repeat,
    shared_every) and the one shared ``decoder`` layer as "shared_attn":
    the JAX tree's structure and keys."""
    params: Dict[str, Any] = {"segments": []}
    for pattern, repeat in cfg.layout_:
        if pattern == "zamba_super":
            params["segments"].append(layer_init(
                cfg, "mamba", gen, lead=(repeat, cfg.shared_every)))
            params["shared_attn"] = layer_init(cfg, "decoder", gen)
            continue
        params["segments"].append(layer_init(cfg, pattern, gen,
                                             lead=(repeat,)))
    return params


def _applications(cfg: ArchConfig, params, seg_params, pattern: str,
                  repeat: int, grad: bool) -> list:
    """(pattern, one layer's params) for each layer of a segment, in the
    order the stack applies them: under autograd from one ``unbind`` a
    leaf, else as views."""
    def split(tree, n):
        return (_unbind(tree, n) if grad
                else [_index(tree, i) for i in range(n)])
    if pattern != "zamba_super":
        return [(pattern, p) for p in split(seg_params, repeat)]
    out = []
    for run in split(seg_params, repeat):
        out.append(("decoder", params["shared_attn"]))
        out += [("mamba", p) for p in split(run, cfg.shared_every)]
    return out


def stack_prefill(cfg: ArchConfig, params, x, positions, memory=None,
                  tp=None):
    """Returns (x, aux): aux is the fp32 sum of the layers' MoE
    load-balance losses, 0 without MoE.  ``memory``: the encoder frames
    the ``encdec`` layers attend (None for the other patterns); ``tp``: a
    model group splitting the ``decoder`` layers."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (pattern, repeat) in zip(params["segments"], cfg.layout_):
        grad = torch.is_grad_enabled() and (
            x.requires_grad or _requires_grad(seg_params)
            or _requires_grad(params.get("shared_attn", {})))
        for kind, p in _applications(cfg, params, seg_params, pattern,
                                     repeat, grad):
            if grad:
                x, a = checkpoint(functools.partial(layer_prefill, cfg, kind,
                                                    tp=tp),
                                  p, x, positions, memory,
                                  use_reentrant=False, early_stop=True)
            else:
                x, a = layer_prefill(cfg, kind, p, x, positions, memory, tp)
            aux = aux if a is None else aux + a
    return x, aux


def stack_init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                     device=None) -> List[Dict[str, Any]]:
    """Per segment, each sub-block's cache stacked on a leading L axis;
    ``zamba_super``'s as {"mamba": on (repeat, shared_every), "shared":
    the shared block's on (repeat,)}."""
    caches = []
    for pattern, repeat in cfg.layout_:
        if pattern == "zamba_super":
            caches.append({
                "mamba": layer_init_cache(
                    cfg, "mamba", batch, cache_len,
                    lead=(repeat, cfg.shared_every), device=device),
                "shared": layer_init_cache(cfg, "decoder", batch, cache_len,
                                           lead=(repeat,), device=device)})
            continue
        caches.append(layer_init_cache(cfg, pattern, batch, cache_len,
                                       lead=(repeat,), device=device))
    return caches


def stack_decode(cfg: ArchConfig, params, caches, x, cur_pos, memory=None):
    """One token through every layer; the caches are updated in place and
    returned.  ``memory`` as for ``stack_prefill``."""
    def at(cache, i):
        return {k: c.layer(i) for k, c in cache.items()}
    for seg_params, seg_cache, (pattern, repeat) in zip(
            params["segments"], caches, cfg.layout_):
        for i in range(repeat):
            if pattern != "zamba_super":
                x = layer_decode(cfg, pattern, _index(seg_params, i), x,
                                 at(seg_cache, i), cur_pos, memory)
                continue
            x = layer_decode(cfg, "decoder", params["shared_attn"], x,
                             at(seg_cache["shared"], i), cur_pos)
            run, run_cache = _index(seg_params, i), at(seg_cache["mamba"], i)
            for j in range(cfg.shared_every):
                x = layer_decode(cfg, "mamba", _index(run, j), x,
                                 at(run_cache, j), cur_pos)
    return x, caches
