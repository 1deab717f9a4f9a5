"""Core layers: init helpers, norms, MLPs, RoPE, embeddings and the head
(``repro/models/layers.py``).  Plain functions on tensors; params are dicts
of tensors; initialisers draw from an explicit ``torch.Generator`` that
lies on the target device.

The MLP, the embedding and the head take an optional ``tp``: a
``launch.mesh.FleetMesh`` whose ``model`` group splits them (tensor
parallelism, ``launch/sharding.ModelAxis``).  Then the params are this
rank's shards: ``w_gate`` / ``w_up`` / ``b_up`` by columns, ``w_down``
by rows, the embedding table (and the tied head) by vocab rows; the
config is the local one (``d_ff`` over the group).  ``tp=None`` is the
unsplit model."""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives
from repro_torch.models.config import ArchConfig


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal at +-2 std, std = fan_in**-0.5, fan_in = shape[-2]
    (so a layer-stacked (L, d_in, d_out) weight has the fan-in of one
    layer's), drawn in fp32 on ``gen``'s device, scaled in place and cast
    into the output.  A stacked leaf (3-D or more) is drawn one slice of
    its leading axis at a time, so the fp32 temporary is one layer's (587
    MB for yi-34b's gate, where the whole leaf's would be 35 GB beside
    51 GB of params already drawn); a 2-D leaf is drawn whole."""
    shape = tuple(shape)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:              # shapes only (``model.meta_params``)
        return out
    for part in (out if out.dim() > 2 else (out,)):
        t = torch.empty(part.shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        part.copy_(t.mul_(std))
    return out


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype) -> torch.Tensor:
    """N(0, 0.02^2), drawn in fp32 and scaled in place (one fp32 temporary:
    command-r-35b's table is 8.4 GB of it), then cast."""
    t = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return t.mul_(0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, d: int, *, lead: Sequence[int] = (),
              device=None):
    """``lead`` stacks the params (a leading L axis)."""
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=cfg.weight_dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=cfg.weight_dtype, device=device)
    return p


def norm_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """rmsnorm or layernorm in fp32, out in x's dtype."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Bounded pre-activation ``cap * tanh(x / cap)`` (the xLSTM gates')."""
    return cap * torch.tanh(x / cap)


def rms_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Parameter-free RMS normalization (qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def mlp_init(cfg: ArchConfig, gen: torch.Generator, *,
             lead: Sequence[int] = ()):
    d, f, wd = cfg.d_model, cfg.d_ff, cfg.weight_dtype
    lead = tuple(lead)
    if cfg.mlp_type == "swiglu":
        return {"w_gate": dense_init(gen, lead + (d, f), wd),
                "w_up": dense_init(gen, lead + (d, f), wd),
                "w_down": dense_init(gen, lead + (f, d), wd)}
    p = {"w_up": dense_init(gen, lead + (d, f), wd),
         "w_down": dense_init(gen, lead + (f, d), wd)}
    if cfg.mlp_bias:
        p["b_up"] = torch.zeros(lead + (f,), dtype=wd, device=gen.device)
        p["b_down"] = torch.zeros(lead + (d,), dtype=wd, device=gen.device)
    return p


def row_product(h: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``h @ w``.  With a model group ``tp``, ``w`` holds this rank's rows
    of the weight and ``h`` the matching columns: the partial products are
    taken in fp32, summed over the group and rounded once to ``h``'s
    dtype, as one product over the whole contraction rounds once."""
    if tp is None:
        return h @ w
    return collectives.tp_reduce(h.float() @ w.float(), tp).to(h.dtype)


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor, tp=None) -> torch.Tensor:
    if tp is not None:
        x = collectives.tp_copy(x, tp)
    if cfg.mlp_type == "swiglu":
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        if cfg.mlp_type == "squared_relu":
            h = torch.relu(h).square()
        else:    # gelu, tanh form (jax.nn.gelu's default)
            h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = row_product(h, p["w_down"], tp)
    if "b_down" in p:
        y = y + p["b_down"]
    return y


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta^(2i / head_dim) in fp32: the exponent rounded to fp32, the
    power and the reciprocal taken in fp64 and rounded once.  That is the
    value the reference's compiled ``rope_freqs`` gives at every head dim
    of the configs; torch's fp32 ``pow`` misses it by an ulp in about a
    third of the entries, which moves an angle near position 2^19 by up
    to 0.03 rad.  Built once a (head_dim, theta, device), so that a
    decode step launches nothing for it (not to be written to); built
    afresh on the meta device, where a step's memory is reckoned."""
    dev = torch.device("cpu" if device is None else device)
    build = _rope_freqs.__wrapped__ if dev.type == "meta" else _rope_freqs
    return build(head_dim, float(theta), dev)


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=device) / head_dim
    return (1.0 / theta ** e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split-half
    rotation (not interleaved) with fp32 angles, out in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs     # (..., s, hd/2)
    angles = angles[..., None, :]                        # (..., s, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def embedding_init(cfg: ArchConfig, gen: torch.Generator):
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model),
                           cfg.weight_dtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.weight_dtype)
    if cfg.pos_embed == "learned":
        p["pos"] = embed_init(gen, (cfg.max_seq_len, cfg.d_model),
                              cfg.weight_dtype)
    return p


def embed_tokens(cfg: ArchConfig, p, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 tp=None) -> torch.Tensor:
    if tp is None:
        x = p["tok"][tokens.long()]
    else:
        x = collectives.tp_embed(p["tok"], tokens.long(), tp)
    x = x.to(cfg.activation_dtype)
    if cfg.pos_embed == "learned":
        pos = positions if positions is not None else torch.arange(
            tokens.shape[-1], device=tokens.device)
        x = x + p["pos"][pos.long()].to(x.dtype)
    return x


def lm_logits(cfg: ArchConfig, p, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Logits in fp32; the tied head is ``tok.T``.  With ``tp``, this
    rank's vocab columns."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    if tp is not None:
        x = collectives.tp_copy(x, tp)
    return (x @ w.to(x.dtype)).float()
