"""xLSTM blocks [arXiv:2405.04517] (``repro/models/xlstm.py``): mLSTM
(matrix memory) and sLSTM (scalar memory with recurrent gate connections).

Prefill: the mLSTM runs its chunkwise-parallel form when
``cfg.mlstm_chunk`` is set (the full config) and the per-step recurrence
otherwise, both in plain PyTorch as in JAX (no Pallas kernel there).  The
sLSTM recurrence goes through ``kernels.ops.slstm_scan`` where the JAX
model runs a ``lax.scan``: the hand-written Hopper kernel on the card
(under grad with its hand-written reverse scan as the gradient), the plain
per-step version on the host.  Both keep h in fp32; the JAX step
rounds h and h @ R to the weights' dtype, so in bf16 the two differ by that
rounding.

Decode runs one step of each recurrence in plain PyTorch, as JAX does, and
updates the layer's state in place (JAX returns new states).  The states
are caches: stacked on a leading L axis like the KV cache, with
``.layer(i)`` giving one layer's views.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, rms_normalize, soft_cap

GATE_CAP = 15.0   # soft cap on the i/f gate pre-activations
NEG_INF = -1e30


def _stacked(values: Sequence[float], lead, device) -> torch.Tensor:
    """An fp32 row broadcast over the leading (layer) axes."""
    row = torch.tensor(values, dtype=torch.float32, device=device)
    return row.expand(tuple(lead) + row.shape).contiguous()


def _copy_into(state: NamedTuple, new: NamedTuple) -> None:
    for dst, src in zip(state, new):
        dst.copy_(src)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor      # (..., B, H, P, P) matrix memory
    n: torch.Tensor      # (..., B, H, P) normalizer
    m: torch.Tensor      # (..., B, H) stabilizer

    def layer(self, i: int) -> "MLSTMState":
        """Layer ``i`` of a layer-stacked state, as views."""
        return MLSTMState(self.C[i], self.n[i], self.m[i])


def _mlstm_dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model           # projection factor 2
    H = cfg.n_heads
    return d_inner, H, d_inner // H


def init_mlstm_state(cfg: ArchConfig, batch: int, *, lead=(),
                     device=None) -> MLSTMState:
    _, H, P = _mlstm_dims(cfg)
    shape = tuple(lead) + (batch, H)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros(shape + (P, P), **f32),
                      n=torch.zeros(shape + (P,), **f32),
                      m=torch.full(shape, NEG_INF, **f32))


def mlstm_init(cfg: ArchConfig, gen: torch.Generator, *, lead=()):
    d = cfg.d_model
    d_inner, H, _ = _mlstm_dims(cfg)
    wd, lead = cfg.weight_dtype, tuple(lead)
    return {
        "w_up": dense_init(gen, lead + (d, 2 * d_inner), wd),  # x, z gate
        "wq": dense_init(gen, lead + (d_inner, d_inner), wd),
        "wk": dense_init(gen, lead + (d_inner, d_inner), wd),
        "wv": dense_init(gen, lead + (d_inner, d_inner), wd),
        "w_if": dense_init(gen, lead + (d_inner, 2 * H), wd, scale=0.01),
        "b_if": _stacked([0.0] * H + [3.0] * H, lead, gen.device),
        "norm_scale": torch.ones(lead + (d_inner,), dtype=wd,
                                 device=gen.device),
        "w_down": dense_init(gen, lead + (d_inner, d), wd),
    }


def _mlstm_step(state: MLSTMState, qkvif):
    """One step: q, k, v (B,H,P) and gates i, f (B,H), fp32."""
    q, k, v, i_t, f_t = qkvif
    scale = q.shape[-1] ** -0.5
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + state.m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(logf + state.m - m_new)
    C = state.C * f_p[..., None, None] \
        + i_p[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = state.n * f_p[..., None] + i_p[..., None] * k
    qs = q * scale
    h_num = torch.einsum("bhpq,bhq->bhp", C, qs)
    h_den = torch.maximum(torch.einsum("bhp,bhp->bh", n, qs).abs(),
                          torch.exp(-m_new))
    return MLSTMState(C, n, m_new), h_num / h_den[..., None]


def _mlstm_qkvif(cfg: ArchConfig, p, xu):
    """xu: (B, S, d_inner) -> per-head q, k, v (B,S,H,P) and gates
    (B,S,H), with qk-norm on q and k."""
    _, H, P = _mlstm_dims(cfg)
    B, S, _ = xu.shape
    q = (xu @ p["wq"]).reshape(B, S, H, P)
    k = (xu @ p["wk"]).reshape(B, S, H, P)
    v = (xu @ p["wv"]).reshape(B, S, H, P)
    gates = soft_cap((xu @ p["w_if"]).float() + p["b_if"], GATE_CAP)
    return (rms_normalize(q), rms_normalize(k), v, gates[..., :H],
            gates[..., H:])


def _mlstm_chunk_step(state: MLSTMState, qkvif, *, scale: float):
    """One chunk of the chunkwise-parallel mLSTM (exact, stabilized): with
    b_j = sum_{s<=j} log sigmoid(f_s) and u_k = i_k - b_k, the running
    stabilizer is m_j = b_j + max(m_0, cummax_{k<=j} u_k), the carried state
    scales by c_j = exp(b_j + m_0 - m_j), and in-chunk pairs weigh
    A_jk = exp(b_j - m_j + u_k) for k <= j.  Every exponent is <= 0.  The
    pairs k > j are masked in the exponent (-inf) before ``exp``: the
    reference masks after it, and a masked pair's exponent, up to the sum
    of the chunk's -log sigmoid(f), overflows once the forget gates close
    (past 88 in fp32), which leaves the forward's values alone but makes
    ``where``'s gradient 0 * inf = NaN for i and f."""
    C0, n0, m0 = state                     # (B,H,P,P), (B,H,P), (B,H)
    q, k, v, i_t, f_t = qkvif              # (B,T,H,P) x3, (B,T,H) x2
    logf = F.logsigmoid(f_t)
    b = torch.cumsum(logf, dim=1)          # (B,T,H)
    u = i_t - b
    g = torch.cummax(u, dim=1).values
    m = b + torch.maximum(m0[:, None], g)
    c = torch.exp(b + m0[:, None] - m)     # inter-chunk coefficient
    expo = (b - m)[:, :, None, :] + u[:, None, :, :]      # (B,Tq,Tk,H)
    T = q.shape[1]
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    A = torch.exp(torch.where(mask[None, :, :, None], expo, float("-inf")))

    qs = q * scale
    inter_num = torch.einsum("bthq,bhpq->bthp", qs, C0) * c[..., None]
    S_ = torch.einsum("bthp,bshp->btsh", qs, k) * A       # (B,Tq,Tk,H)
    h_num = inter_num + torch.einsum("btsh,bshp->bthp", S_, v)
    n = c[..., None] * n0[:, None] + torch.einsum("btsh,bshp->bthp", A, k)
    h_den = torch.maximum(torch.einsum("bthp,bthp->bth", n, qs).abs(),
                          torch.exp(-m))
    h = h_num / h_den[..., None]

    # end-of-chunk carry (row j = T-1)
    AT = A[:, -1]                                         # (B,Tk,H)
    C_T = C0 * c[:, -1, :, None, None] \
        + torch.einsum("bsh,bshp,bshq->bhpq", AT, v, k)
    return MLSTMState(C_T, n[:, -1], m[:, -1]), h


def _mlstm_prefill_chunkwise(cfg: ArchConfig, q, k, v, i_t, f_t, B, S):
    """Chunk by chunk over S/T chunks; exact w.r.t. the per-step form.
    Padded steps add nothing (i = -1e30) and decay nothing (f = 30)."""
    T = cfg.mlstm_chunk
    P = q.shape[-1]
    pad = (-S) % T
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_t = F.pad(i_t, (0, 0, 0, pad), value=NEG_INF)
        f_t = F.pad(f_t, (0, 0, 0, pad), value=30.0)
    state = init_mlstm_state(cfg, B, device=q.device)
    hs = []
    for t0 in range(0, S + pad, T):
        chunk = tuple(t[:, t0:t0 + T].float() for t in (q, k, v, i_t, f_t))
        state, h = _mlstm_chunk_step(state, chunk, scale=P ** -0.5)
        hs.append(h)
    return torch.cat(hs, dim=1).reshape(B, S + pad, -1)[:, :S]


def _mlstm_out(p, h, z, x):
    h = rms_normalize(h) * p["norm_scale"].float()
    out = h.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    return out @ p["w_down"]


def mlstm_prefill(cfg: ArchConfig, p, x):
    """x: (B, S, d) -> (B, S, d)."""
    d_inner, H, P = _mlstm_dims(cfg)
    B, S, _ = x.shape
    up = x @ p["w_up"]
    xu, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v, i_t, f_t = _mlstm_qkvif(cfg, p, xu)
    if cfg.mlstm_chunk and S > 1:
        h = _mlstm_prefill_chunkwise(cfg, q, k, v, i_t, f_t, B, S)
    else:
        state = init_mlstm_state(cfg, B, device=x.device)
        hs = []
        for t in range(S):
            state, h_t = _mlstm_step(state, tuple(
                a[:, t].float() for a in (q, k, v, i_t, f_t)))
            hs.append(h_t)
        h = torch.stack(hs, dim=1)
    return _mlstm_out(p, h.reshape(B, S, d_inner), z, x)


def mlstm_decode(cfg: ArchConfig, p, x, state: MLSTMState):
    """x: (B, 1, d).  Returns (out (B, 1, d), state updated in place)."""
    d_inner, _, _ = _mlstm_dims(cfg)
    B = x.shape[0]
    up = x @ p["w_up"]
    xu, z = up[..., :d_inner], up[..., d_inner:]
    q, k, v, i_t, f_t = _mlstm_qkvif(cfg, p, xu)
    new, h = _mlstm_step(state, tuple(a[:, 0].float()
                                      for a in (q, k, v, i_t, f_t)))
    _copy_into(state, new)
    return _mlstm_out(p, h.reshape(B, 1, d_inner), z, x), state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor      # (..., B, d) cell
    n: torch.Tensor      # (..., B, d) normalizer
    h: torch.Tensor      # (..., B, d) hidden (recurrent input)
    m: torch.Tensor      # (..., B, d) stabilizer

    def layer(self, i: int) -> "SLSTMState":
        """Layer ``i`` of a layer-stacked state, as views."""
        return SLSTMState(self.c[i], self.n[i], self.h[i], self.m[i])


def init_slstm_state(cfg: ArchConfig, batch: int, *, lead=(),
                     device=None) -> SLSTMState:
    shape = tuple(lead) + (batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros(shape, **f32), n=torch.zeros(shape, **f32),
                      h=torch.zeros(shape, **f32),
                      m=torch.full(shape, NEG_INF, **f32))


def slstm_init(cfg: ArchConfig, gen: torch.Generator, *, lead=()):
    d, H = cfg.d_model, cfg.n_heads
    P = d // H
    wd, lead = cfg.weight_dtype, tuple(lead)
    ff = int(4 / 3 * d)
    return {
        "w_gates": dense_init(gen, lead + (d, 4 * d), wd),   # i, f, z, o
        # block-diagonal recurrent weights: (H, P, 4P)
        "r_gates": dense_init(gen, lead + (H, P, 4 * P), wd,
                              scale=P ** -0.5),
        "b_gates": _stacked([0.0] * d + [3.0] * d + [0.0] * (2 * d), lead,
                            gen.device),
        "w_ff_gate": dense_init(gen, lead + (d, ff), wd),
        "w_ff_up": dense_init(gen, lead + (d, ff), wd),
        "w_ff_down": dense_init(gen, lead + (ff, d), wd),
    }


def _slstm_step(cfg: ArchConfig, p, state: SLSTMState, wx):
    """wx: (B, 4d) fp32 input contribution of this step.  As in JAX, h is
    rounded to the weights' dtype before h @ R."""
    d, H = cfg.d_model, cfg.n_heads
    B = wx.shape[0]
    r = p["r_gates"]
    hr = state.h.reshape(B, H, d // H).to(r.dtype)
    rec = torch.einsum("bhp,hpq->bhq", hr, r).reshape(B, 4 * d)
    g = (wx + rec).float() + p["b_gates"]
    gi, gf, gz, go = g.chunk(4, dim=-1)
    gi, gf = soft_cap(gi, GATE_CAP), soft_cap(gf, GATE_CAP)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + state.m, gi)
    i_p = torch.exp(gi - m_new)
    f_p = torch.exp(logf + state.m - m_new)
    c = f_p * state.c + i_p * torch.tanh(gz)
    n = f_p * state.n + i_p
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return SLSTMState(c=c, n=n, h=h, m=m_new), h


def _slstm_ffn(p, h, x):
    """rms-normalized h through the GeGLU post-FFN."""
    h = rms_normalize(h.to(x.dtype))
    g = h @ p["w_ff_gate"]
    u = h @ p["w_ff_up"]
    y = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    return y @ p["w_ff_down"]


def slstm_prefill(cfg: ArchConfig, p, x):
    """x: (B, S, d) -> (B, S, d); the recurrence through the sLSTM scan
    kernel (one launch a call on the card)."""
    wx = (x @ p["w_gates"]).float()                       # (B, S, 4d)
    h = ops.slstm_scan(wx, p["r_gates"], p["b_gates"])    # (B, S, d) fp32
    return _slstm_ffn(p, h, x)


def slstm_decode(cfg: ArchConfig, p, x, state: SLSTMState):
    """x: (B, 1, d).  Returns (out (B, 1, d), state updated in place)."""
    wx = (x[:, 0] @ p["w_gates"]).float()
    new, h = _slstm_step(cfg, p, state, wx)
    _copy_into(state, new)
    return _slstm_ffn(p, h[:, None], x), state
