"""Mixture-of-Experts feed-forward (``repro/models/moe.py``): GShard /
Switch capacity routing with top-k softmax gates, routed SwiGLU experts
carrying a leading E axis, optional always-on shared experts.

The reference's semantics are kept exactly:

- tokens go in groups of ``min(group_size, B*S)``, the last one padded
  with zero rows;
- the router is fp32: softmax gates, the top-k of them (ties to the lower
  expert id, as ``jax.lax.top_k``) as a {0, 1} mask, and the Switch
  load-balance loss ``E * mean_g sum_e f_e P_e``;
- ``dispatch_impl="einsum"``: each expert takes ``C = max(1, int(top_k *
  S * capacity_factor / E))`` tokens a group, slots given in token order
  (``cumsum(mask) * mask - 1``), assignments at or past C dropped; the
  combine weights are ``gates * mask`` in the activation dtype, not
  renormalised;
- ``dispatch_impl="ragged"``: no capacity; one stable argsort of the
  (token, expert) pairs by expert, per-expert products over contiguous
  slices, the fp32 top-k gates as combine weights;
- the shared experts are added after the routed ones.

The reference writes the capacity dispatch as one-hot ``(G, S, E, C)``
einsums, which at deepseek-v2-lite's prefill (32,768 tokens, E = 64, C =
240) cost about 4 TFLOP and 3 GB of temporaries a layer.  Here the same
slots are filled by an index write and read back by a gather: each slot
holds at most one token, so the expert inputs are the same values, and
the combine sums the same top-k terms.  The expert products are
``torch.bmm`` over ``(E, G*C, d) @ (E, d, F)``; the reference runs no
Pallas kernel anywhere in MoE.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init


def moe_init(cfg: ArchConfig, gen: torch.Generator, *,
             lead: Sequence[int] = ()):
    """``router`` (d, E) fp32 and the experts' (E, d, F) / (E, F, d) in
    the weight dtype, each behind ``lead`` (a leading L axis); the shared
    experts as one SwiGLU of width ``n_shared * F``."""
    m, d, wd, lead = cfg.moe, cfg.d_model, cfg.weight_dtype, tuple(lead)
    E, Fe = m.n_experts, m.expert_d_ff
    p = {"router": dense_init(gen, lead + (d, E), torch.float32),
         "w_gate": dense_init(gen, lead + (E, d, Fe), wd),
         "w_up": dense_init(gen, lead + (E, d, Fe), wd),
         "w_down": dense_init(gen, lead + (E, Fe, d), wd)}
    if m.n_shared:
        Fs = m.n_shared * Fe
        p["shared"] = {"w_gate": dense_init(gen, lead + (d, Fs), wd),
                       "w_up": dense_init(gen, lead + (d, Fs), wd),
                       "w_down": dense_init(gen, lead + (Fs, d), wd)}
    return p


def _swiglu(x, w_gate, w_up, w_down):
    h = F.silu((x @ w_gate).float()).to(x.dtype) * (x @ w_up)
    return h @ w_down


def _top_k(gates: torch.Tensor, k: int):
    """(values, ids) of the k largest gates, largest first, ties to the
    lower id (``jax.lax.top_k``'s order; a padded zero row has E equal
    gates)."""
    vals, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(cfg: ArchConfig, p, xg):
    """Router on fp32 softmax gates: (top-k ids (G,S,k), top-k gates
    (G,S,k), mask (G,S,E) in {0, 1}, aux loss)."""
    m = cfg.moe
    gates = torch.softmax(xg.float() @ p["router"], dim=-1)
    top_val, top_idx = _top_k(gates, m.top_k)
    mask = torch.zeros_like(gates).scatter_(-1, top_idx, 1.0)
    f = mask.mean(dim=1)                                # (G,E)
    pr = gates.mean(dim=1)                              # (G,E)
    aux = m.n_experts * (f * pr).sum(dim=-1).mean()
    return top_idx, top_val, mask, aux


def _dispatch_capacity(cfg: ArchConfig, p, xg, top_idx, top_val, mask):
    """GShard capacity dispatch by slot index.  Pair (g, s, j) goes to
    slot ``pos`` of expert ``e = top_idx[g, s, j]`` in group g, ``pos`` its
    rank among the group's tokens routed to e; pairs with ``pos >= C`` are
    dropped (their slot is a spare row past the E*G*C real ones, and their
    combine weight is 0)."""
    m = cfg.moe
    G, S, d = xg.shape
    E, K = m.n_experts, m.top_k
    C = max(1, int(m.top_k * S * m.capacity_factor / E))
    pos = (torch.cumsum(mask, dim=1) * mask - 1.0).gather(-1, top_idx)
    kept = pos < C                                      # (G,S,K); pos >= 0
    groups = torch.arange(G, device=xg.device)[:, None, None]
    slot = (top_idx * G + groups) * C + pos.long()
    spare = E * G * C
    slot = torch.where(kept, slot, spare).reshape(G * S, K)
    xf = xg.reshape(G * S, d)
    buf = xg.new_zeros((spare + 1, d))
    for j in range(K):
        buf[slot[:, j]] = xf
    h = torch.bmm(buf[:spare].view(E, G * C, d), p["w_gate"])
    u = torch.bmm(buf[:spare].view(E, G * C, d), p["w_up"])
    h = F.silu(h.float()).to(xg.dtype) * u
    y = torch.bmm(h, p["w_down"]).view(spare, d)
    cw = torch.where(kept, top_val, 0.0).to(xg.dtype).float()
    cw = cw.reshape(G * S, K)
    slot = slot.clamp(max=spare - 1)
    out = torch.zeros((G * S, d), dtype=torch.float32, device=xg.device)
    for j in range(K):
        out.add_(y[slot[:, j]].float() * cw[:, j, None])
    return out.to(xg.dtype).view(G, S, d)


def _dispatch_ragged(cfg: ArchConfig, p, xg, top_idx, top_val):
    """Sort-based dispatch without capacity: one stable argsort of the
    (token, expert) pairs by expert, then each expert's SwiGLU over its
    contiguous slice.  The slices' sizes are read on the host once a call
    (a device sync), and the experts run as a loop of E products, where
    the reference calls ``jax.lax.ragged_dot``."""
    m = cfg.moe
    G, S, d = xg.shape
    E, K = m.n_experts, m.top_k
    N = G * S
    x = xg.reshape(N, d)
    eid = top_idx.reshape(-1)
    tok = torch.arange(N, device=x.device).repeat_interleave(K)
    order = torch.argsort(eid, stable=True)
    tok_s = tok[order]
    xs = x[tok_s]
    sizes = torch.bincount(eid, minlength=E).tolist()
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            ys[start:start + n] = _swiglu(xs[start:start + n],
                                          p["w_gate"][e], p["w_up"][e],
                                          p["w_down"][e])
        start += n
    w = top_val.reshape(-1)[order].float()
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, tok_s, ys.float() * w[:, None])
    return out.to(x.dtype).view(G, S, d)


def moe_apply(cfg: ArchConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32 scalar)."""
    m = cfg.moe
    B, S, d = x.shape
    tokens = B * S
    gs = min(m.group_size, tokens)
    n_groups = -(-tokens // gs)
    xf = x.reshape(tokens, d)
    pad = n_groups * gs - tokens
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
    xg = xf.view(n_groups, gs, d)

    top_idx, top_val, mask, aux = _route(cfg, p, xg)
    if m.dispatch_impl == "ragged":
        out = _dispatch_ragged(cfg, p, xg, top_idx, top_val)
    else:
        out = _dispatch_capacity(cfg, p, xg, top_idx, top_val, mask)
    out = out.reshape(n_groups * gs, d)[:tokens].view(B, S, d)

    if m.n_shared:
        sp = p["shared"]
        out = out + _swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"])
    return out, aux
