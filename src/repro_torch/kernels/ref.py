"""Plain PyTorch versions of the port's kernels.

Each mirrors its kernel's contract and the JAX package's
``repro/kernels/ref.py``.  The CPU route of ``kernels/ops`` runs them, the
tests hold them against the JAX Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  They repeat the
kernels' arithmetic in straightforward form and are no yardstick of speed.

The aggregation and update versions take the kernels' scenario axis too
(a multi-scenario sweep's S stacked fleets): every (A, N) / (R, N) operand
may carry a leading S, the per-agent ones (S, A) or one shared (A,), and
the update's anchors and hyper-parameters one row or value a scenario.
They broadcast over it, and agree with S calls of the same function.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import (buffer_absorb, normalized_weights,
                                          scatter_accumulate)

NEG_INF = -1e30


def _mask(S: int, T: int, causal: bool, window: int, device):
    """The (S, T) mask of queries at positions 0..S-1 over keys at 0..T-1,
    as ``chunked_attention`` builds it from ``q_pos`` and ``kv_pos``."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Dense-softmax attention in fp32.  q: (B,S,H,D); k: (B,T,KV,D); v:
    (B,T,KV,Dv), whose head dim may differ from q's and k's (MLA: 192 and
    128) and whose length T may differ from S (cross-attention over an
    encoder memory); scale D**-0.5; out (B,S,H,Dv) in q's dtype."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = D ** -0.5
    qg = q.reshape(B, S, KV, G, D).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.float()) * scale
    mask = _mask(S, T, causal, window, q.device)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """The log-sum-exp that ``flash_attention(..., return_lse=True)`` saves
    for the backward: (B, H, S) fp32 ``log2 sum_t 2^(q_s . k_t * D**-0.5 *
    log2 e)`` over the live keys, i.e. the natural logsumexp of the scaled
    scores times log2 e.  q: (B,S,H,D); k: (B,T,KV,D)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * D ** -0.5
    s = s.masked_fill(~_mask(S, T, causal, window, q.device), float("-inf"))
    lse = torch.logsumexp(s, dim=-1) * 1.4426950408889634
    return lse.reshape(B, H, S)


def slstm_scan_ref(wx, r_gates, b_gates, *, return_state: bool = False):
    """Per-step scan for the sLSTM kernel, all fp32 (R cast to fp32).

    wx: (B, S, 4d); r_gates: (H, P, 4P); b_gates: (4d,) -> (B, S, d) fp32.
    Mirrors ``models/xlstm._slstm_step`` with h kept in fp32, gate soft cap
    included; h @ R is flattened head-major before the gate split.  With
    ``return_state`` also the state after every step, (B, S, 3, d) fp32
    holding (c, n, m), as the kernel saves it for the backward."""
    B, S, _ = wx.shape
    H, P, _ = r_gates.shape
    d = H * P
    rf = r_gates.float()
    bf = b_gates.float()
    c = torch.zeros((B, d), dtype=torch.float32, device=wx.device)
    n, h = torch.zeros_like(c), torch.zeros_like(c)
    m = torch.full_like(c, NEG_INF)
    hs, states = [], []
    for t in range(S):
        rec = torch.einsum("bhp,hpq->bhq", h.reshape(B, H, P),
                           rf).reshape(B, 4 * d)
        g = wx[:, t].float() + rec + bf
        gi, gf, gz, go = g.chunk(4, dim=-1)
        gi = 15.0 * torch.tanh(gi / 15.0)
        gf = 15.0 * torch.tanh(gf / 15.0)
        logf = torch.nn.functional.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)
        i_p = torch.exp(gi - m_new)
        f_p = torch.exp(logf + m - m_new)
        c = f_p * c + i_p * torch.tanh(gz)
        n = f_p * n + i_p
        h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
        if return_state:
            states.append(torch.stack((c, n, m), dim=1))
    if not hs:
        out = torch.zeros((B, 0, d), dtype=torch.float32, device=wx.device)
        return (out, out.new_zeros((B, 0, 3, d))) if return_state else out
    out = torch.stack(hs, dim=1)
    return (out, torch.stack(states, dim=1)) if return_state else out


def slstm_scan_bwd_ref(dh, wx, r_gates, b_gates, h, state):
    """The sLSTM scan's backward as an explicit reverse scan, the plain
    version of ``kernels/slstm_scan.slstm_scan_bwd`` (its arithmetic in the
    kernel's order): (dwx (B, S, 4d) fp32, dR in R's dtype, db (4d,) fp32)
    of ``slstm_scan_ref(wx, r_gates, b_gates)`` at the upstream gradient
    dh (B, S, d), given its output h and its saved state (B, S, 3, d) of
    (c, n, m) after each step.  The gradient of every op of the forward:
    the soft cap, ``log_sigmoid``, the stabiliser (``torch.maximum``
    gives each side half of a tie's gradient, as ``jnp.maximum`` does; at
    t = 0, m = -1e30 makes i the larger), and ``clamp(n, min=1)``, whose
    gradient passes at n == 1.  Each step recomputes its gates from
    h_{t-1} and adds its share of dR and db; the serial part carries (dc,
    dn, dm) and the recurrent dh_{t-1} = R[head] . dg_t[head] from step
    to step."""
    B, S, d = h.shape
    H, P, _ = r_gates.shape
    rf, bf = r_gates.float(), b_gates.float()
    dg = torch.empty((B, S, 4 * d), dtype=torch.float32, device=h.device)
    dr = torch.zeros((H, P, 4 * P), dtype=torch.float32, device=h.device)
    zero = torch.zeros((B, d), dtype=torch.float32, device=h.device)
    dc, dn, dm, dh_rec = zero, zero, zero, zero
    for t in reversed(range(S)):
        if t:
            c0, n0, m0 = state[:, t - 1].unbind(1)
            h0 = h[:, t - 1].reshape(B, H, P)
        else:
            c0, n0, m0 = zero, zero, torch.full_like(zero, NEG_INF)
            h0 = zero.reshape(B, H, P)
        c, n = state[:, t, 0], state[:, t, 1]
        g = wx[:, t].float() + torch.einsum(
            "bhp,hpq->bhq", h0, rf).reshape(B, 4 * d) + bf
        gi_r, gf_r, gz, go = g.chunk(4, dim=-1)
        ti, tf = torch.tanh(gi_r / 15.0), torch.tanh(gf_r / 15.0)
        gi, gf = 15.0 * ti, 15.0 * tf
        a = torch.nn.functional.logsigmoid(gf) + m0
        m_new = torch.maximum(a, gi)
        i_p, f_p = torch.exp(gi - m_new), torch.exp(a - m_new)
        tz, so = torch.tanh(gz), torch.sigmoid(go)
        nc = torch.clamp(n, min=1.0)
        x = so * c
        dht = dh[:, t] + dh_rec
        dx = dht / nc
        dn = dn + torch.where(n >= 1.0, -dht * x / (nc * nc), 0.0)
        dc = dc + dx * so
        dgo = dx * c * (1.0 - so) * so
        dgz = dc * i_p * (1.0 - tz * tz)
        die = (dc * tz + dn) * i_p          # through exp(gi - m')
        dfe = (dc * c0 + dn * n0) * f_p     # through exp(a - m')
        dc, dn = dc * f_p, dn * f_p
        dmn = dm - dfe - die
        half = 0.5 * dmn
        da = dfe + torch.where(a > gi, dmn, torch.where(a == gi, half, 0.0))
        dgi = die + torch.where(gi > a, dmn, torch.where(a == gi, half, 0.0))
        dm = da
        dgf = da * torch.sigmoid(-gf)
        dg[:, t] = torch.cat((dgi * (1.0 - ti * ti), dgf * (1.0 - tf * tf),
                              dgz, dgo), dim=-1)
        dg_t = dg[:, t].reshape(B, H, 4 * P)
        dh_rec = torch.einsum("bhq,hpq->bhp", dg_t, rf).reshape(B, d)
        dr = dr + torch.einsum("bhp,bhq->hpq", h0, dg_t)
    return dg, dr.to(r_gates.dtype), dg.sum(dim=(0, 1))


def dual_proximal_sgd_ref(w, g, a1, a2, *, lr, mu1, mu2, scale=None,
                          active_steps=None, step: int = 0) -> torch.Tensor:
    """w - lr*(g + mu1*(w - a1) + mu2*(w - a2)); ``scale`` (A,) multiplies
    each row's lr, or ``active_steps`` (A,) with ``step`` gives the flat
    engine's inline mask ``live = (step < active_steps)`` in its place;
    ``a1`` / ``a2`` broadcast against ``w`` (an (N,) row serves every
    agent, a (G, N) anchor a group of rows each).  ``lr`` / ``mu1`` /
    ``mu2`` are floats or (G,) tensors, one value a group of rows."""
    rows = w.shape[0] if w.dim() == 2 else 1
    if active_steps is not None:
        scale = (step < active_steps).float()
    if w.dim() == 2:      # one anchor row / value a group of rows
        a1, a2 = (a if a.dim() == 1 or a.shape[0] in (1, rows) else
                  a.repeat_interleave(rows // a.shape[0], dim=0)
                  for a in (a1, a2))
        lr, mu1, mu2 = (v.repeat_interleave(rows // v.shape[0])[:, None]
                        if isinstance(v, torch.Tensor) else v
                        for v in (lr, mu1, mu2))
    wf = w.float()
    step_v = g.float() + mu1 * (wf - a1.float()) + mu2 * (wf - a2.float())
    lr_t = lr if scale is None else lr * scale.float()[:, None]
    return (wf - lr_t * step_v).to(w.dtype)


def weighted_agg_matmul_ref(weight_matrix, stacked) -> torch.Tensor:
    """(R, A) @ (A, N) in fp32, out in the stacked dtype."""
    return (weight_matrix.float() @ stacked.float()).to(stacked.dtype)


def masked_hier_agg_ref(stacked_flat, weights, mask, rsu_assign, n_rsus):
    """Segment-sum reference for the RSU aggregation."""
    w = weights.float() * mask.float()
    num, mass = scatter_accumulate(stacked_flat, w, rsu_assign, n_rsus)
    denom = torch.where(mass > 0, mass, torch.ones_like(mass))[..., None]
    return (num / denom).to(stacked_flat.dtype), mass


def agg_blend_ref(stacked_flat, weights, mask, rsu_assign, n_rsus, prev):
    """The un-fused two-pass composition the fused kernel reproduces:
    normalized aggregation, then the mass-guard blend; out dtype follows
    ``prev``."""
    new, mass = masked_hier_agg_ref(stacked_flat, weights, mask, rsu_assign,
                                    n_rsus)
    out = torch.where((mass > 0)[..., None], new.float(), prev.float())
    return out.to(prev.dtype), mass


def agg_absorb_ref(arrivals, rsu_assign, n_rsus, buf, buf_mass, *,
                   keep=0.0):
    """Per-cohort scatter-accumulate, numerator add, then
    ``buffer_absorb``.  Returns (buf', total mass, new mass)."""
    num = torch.zeros(buf.shape, dtype=torch.float32, device=buf.device)
    new_mass = torch.zeros(buf.shape[:-1], dtype=torch.float32,
                           device=buf.device)
    for x, w in arrivals:
        n, m = scatter_accumulate(x, w, rsu_assign, n_rsus)
        num = num + n
        new_mass = new_mass + m
    out, total = buffer_absorb(buf, buf_mass, num, new_mass, keep=keep)
    return out, total, new_mass


def chunk_agg_ref(chunk_flat, weights, rsu_assign, n_rsus, *, into=None):
    """``scatter_accumulate`` over one agent chunk; with ``into`` = (num
    (R, N) fp32, mass (R,)) the chunk's terms are added into those in
    place, agent by agent, so a fleet streamed chunk by chunk sums in the
    order of one ``scatter_accumulate`` over all of it."""
    if into is None:
        return scatter_accumulate(chunk_flat, weights, rsu_assign, n_rsus)
    num, mass = into
    w = weights.float()
    mass.index_add_(0, rsu_assign, w)
    num.index_add_(0, rsu_assign, chunk_flat.float() * w[:, None])
    return num, mass


def cloud_agg_ref(rsu_flat, rsu_weights) -> torch.Tensor:
    wn, _ = normalized_weights(rsu_weights)
    return (rsu_flat.float() * wn[..., None]).sum(dim=-2).to(rsu_flat.dtype)


def cloud_blend_ref(rsu_flat, rsu_weights, prev) -> torch.Tensor:
    """Cloud aggregation + keep-guard; out dtype follows ``prev``."""
    new = cloud_agg_ref(rsu_flat, rsu_weights)
    total = rsu_weights.float().sum(dim=-1)
    return torch.where(total[..., None] > 0, new.float(),
                       prev.float()).to(prev.dtype)
