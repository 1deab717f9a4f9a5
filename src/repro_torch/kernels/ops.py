"""The kernels' router, mirroring ``repro/kernels/ops.py``.

A call whose fleet tensor (or query, or wx) lies on a CUDA device launches
the hand-written Hopper kernel (``masked_hier_agg`` / ``dual_proximal_sgd``
/ ``flash_attention`` / ``slstm_scan``), which raises on anything it does
not take.  A call on CPU tensors runs the plain PyTorch version in
``kernels/ref``.  There is no switch that sends CUDA tensors to the plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.aggregation import scatter_accumulate
from repro_torch.kernels import dual_proximal_sgd as _dps
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_hier_agg as _mha
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as _ss


def dual_proximal_sgd(w, g, a1, a2, *, lr: float, mu1: float, mu2: float,
                      scale: Optional[torch.Tensor] = None,
                      active_steps: Optional[torch.Tensor] = None,
                      step: int = 0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 6 step; the row scale is ``scale`` or ``step < active_steps``;
    ``out=w`` updates in place."""
    if w.is_cuda:
        return _dps.dual_proximal_sgd(w, g, a1, a2, lr=lr, mu1=mu1, mu2=mu2,
                                      scale=scale, active_steps=active_steps,
                                      step=step, out=out)
    res = ref.dual_proximal_sgd_ref(w, g, a1, a2, lr=lr, mu1=mu1, mu2=mu2,
                                    scale=scale, active_steps=active_steps,
                                    step=step)
    return res if out is None else out.copy_(res)


def weighted_agg_matmul(weight_matrix, stacked) -> torch.Tensor:
    if stacked.is_cuda:
        return _mha.weighted_agg_matmul(weight_matrix, stacked)
    return ref.weighted_agg_matmul_ref(weight_matrix, stacked)


def masked_hier_agg(stacked_flat, weights, mask, rsu_assign, n_rsus: int):
    """(rsu (R, N) in the fleet dtype, mass (R,)), no blend."""
    if stacked_flat.is_cuda:
        return _mha.masked_hier_agg(stacked_flat, weights, mask, rsu_assign,
                                    n_rsus)
    return ref.masked_hier_agg_ref(stacked_flat, weights, mask, rsu_assign,
                                   n_rsus)


def masked_scatter_accumulate(stacked_flat, weights, rsu_assign,
                              n_rsus: int):
    """Unnormalized per-RSU sums for the async tick: (num (R, N) fp32,
    mass (R,)) = sum_a w_a x_a grouped by RSU (weights carry mask x data
    volume x staleness decay)."""
    if stacked_flat.is_cuda:
        return _mha.scatter_accumulate(stacked_flat, weights, rsu_assign,
                                       n_rsus)
    return scatter_accumulate(stacked_flat, weights, rsu_assign, n_rsus)


def cloud_agg(rsu_flat, rsu_weights) -> torch.Tensor:
    """(R, N) -> (N,) weighted mean, no keep guard."""
    if rsu_flat.is_cuda:
        return _mha.cloud_agg(rsu_flat, rsu_weights)
    return ref.cloud_agg_ref(rsu_flat, rsu_weights)


def agg_blend(stacked_flat, weights, mask, rsu_assign, n_rsus: int, prev):
    """Fused RSU aggregation + mass guard; (rsu' in prev's dtype, mass)."""
    if stacked_flat.is_cuda:
        return _mha.agg_blend(stacked_flat, weights, mask, rsu_assign,
                              n_rsus, prev)
    return ref.agg_blend_ref(stacked_flat, weights, mask, rsu_assign, n_rsus,
                             prev)


def agg_absorb(arrivals, rsu_assign, n_rsus: int, buf, buf_mass, *,
               keep=0.0):
    """Fused multi-cohort absorb; (buf', total mass, new mass)."""
    if buf.is_cuda:
        return _mha.agg_absorb(arrivals, rsu_assign, n_rsus, buf, buf_mass,
                               keep=keep)
    return ref.agg_absorb_ref(arrivals, rsu_assign, n_rsus, buf, buf_mass,
                              keep=keep)


def cloud_blend(rsu_flat, rsu_weights, prev) -> torch.Tensor:
    """Fused cloud aggregation + keep guard; out dtype follows ``prev``."""
    if rsu_flat.is_cuda:
        return _mha.cloud_blend(rsu_flat, rsu_weights, prev)
    return ref.cloud_blend_ref(rsu_flat, rsu_weights, prev)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Online-softmax attention; q (B,S,H,D), k/v (B,S,KV,D); out in q's
    dtype."""
    if q.is_cuda:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


def slstm_scan(wx, r_gates, b_gates) -> torch.Tensor:
    """Forward sLSTM recurrence; wx (B,S,4d) fp32, r_gates (H,P,4P), b_gates
    (4d,) fp32; hidden states (B,S,d) fp32."""
    if wx.is_cuda:
        return _ss.slstm_scan(wx, r_gates, b_gates)
    return ref.slstm_scan_ref(wx, r_gates, b_gates)


_COUNTS = (_mha.launches, _dps.launches, _fa.launches, _ss.launches)


def launch_counts() -> dict:
    """Kernel launches so far, per wrapper entry point."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
