"""The kernels' router, mirroring ``repro/kernels/ops.py``.

A call whose fleet tensor (or query, or wx) lies on a CUDA device launches
the hand-written Hopper kernel (``masked_hier_agg`` / ``dual_proximal_sgd``
/ ``flash_attention`` / ``slstm_scan``), which raises on anything it does
not take.  Under autograd a CUDA route never returns an output without a
gradient: attention has a backward kernel, and every other route raises
when an input needs a gradient.  A call on CPU tensors runs the plain PyTorch version in
``kernels/ref``.  There is no switch that sends CUDA tensors to the plain
version.  The aggregation and update entries also take a multi-scenario
sweep's leading scenario axis, on either route.  On the meta device
(shapes only, as the dry run reckons a step's memory) ``flash_attention``
and ``slstm_scan`` return the new tensor their kernel allocates, and
compute nothing.  Within ``logged_calls()`` each call of those two also
notes its operands' shapes, so that the dry run can count the kernels'
work, which ``torch.utils.flop_counter`` cannot see.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from repro_torch import tree
from repro_torch.core.aggregation import scatter_accumulate
from repro_torch.kernels import dual_proximal_sgd as _dps
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_hier_agg as _mha
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as _ss


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _no_backward(name: str, *ts, wait: str = "") -> None:
    """A CUDA route whose kernel has no backward raises where autograd
    would need one, rather than return an output without a gradient.
    The engines pass detached buffers and ``autograd.grad`` outputs."""
    if _needs_grad(*ts):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward; pass tensors that "
            f"need no gradient{wait}")


def dual_proximal_sgd(w, g, a1, a2, *, lr: float, mu1: float, mu2: float,
                      scale: Optional[torch.Tensor] = None,
                      active_steps: Optional[torch.Tensor] = None,
                      step: int = 0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 6 step; the row scale is ``scale`` or ``step < active_steps``;
    ``out=w`` updates in place."""
    if w.is_cuda:
        _no_backward("dual_proximal_sgd", w, g, a1, a2, lr, mu1, mu2, scale)
        return _dps.dual_proximal_sgd(w, g, a1, a2, lr=lr, mu1=mu1, mu2=mu2,
                                      scale=scale, active_steps=active_steps,
                                      step=step, out=out)
    res = ref.dual_proximal_sgd_ref(w, g, a1, a2, lr=lr, mu1=mu1, mu2=mu2,
                                    scale=scale, active_steps=active_steps,
                                    step=step)
    return res if out is None else out.copy_(res)


def weighted_agg_matmul(weight_matrix, stacked) -> torch.Tensor:
    if stacked.is_cuda:
        _no_backward("weighted_agg_matmul", weight_matrix, stacked)
        return _mha.weighted_agg_matmul(weight_matrix, stacked)
    return ref.weighted_agg_matmul_ref(weight_matrix, stacked)


def masked_hier_agg(stacked_flat, weights, mask, rsu_assign, n_rsus: int):
    """(rsu (R, N) in the fleet dtype, mass (R,)), no blend."""
    if stacked_flat.is_cuda:
        _no_backward("masked_hier_agg", stacked_flat, weights, mask)
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
        _no_backward("masked_scatter_accumulate", stacked_flat, weights)
        return _mha.scatter_accumulate(stacked_flat, weights, rsu_assign,
                                       n_rsus)
    return scatter_accumulate(stacked_flat, weights, rsu_assign, n_rsus)


def block_local_agg(stacked_flat, weights, local_assign, n_rsus_local: int):
    """The sharded rounds' RSU layer on one rank's agents: (num (R_local,
    N) fp32, mass (R_local,)) = sum_a w_a x_a grouped by SHARD-LOCAL RSU
    id in ``[0, n_rsus_local)``, weights unnormalized (mask x data volume
    x any staleness decay).  With agents co-located with their RSU's pod
    this is one pod's diagonal block of the (R, A) weight matrix, so the
    RSU layer needs no traffic across pods; the caller sums it over the
    agent axes it shares its RSUs with and normalizes.  Zero-weight rows
    add nothing, and an RSU with no weight gets mass 0."""
    if stacked_flat.is_cuda:
        _no_backward("block_local_agg", stacked_flat, weights)
        return _mha.scatter_accumulate(stacked_flat, weights, local_assign,
                                       n_rsus_local, entry="block_local_agg")
    return scatter_accumulate(stacked_flat, weights, local_assign,
                              n_rsus_local)


def chunk_agg(chunk_flat, weights, rsu_assign, n_rsus: int, *, into=None):
    """The cohort-streamed rounds' aggregation over ONE agent chunk:
    (num (R, N) fp32, mass (R,)) = sum_a w_a x_a grouped by global RSU id,
    weights unnormalized (mask x data volume x any staleness decay).  With
    ``into`` = (num, mass) running sums (on any device) the chunk's sums
    are added into them, which are returned: the kernel's sums added
    whole, the plain version's agent by agent (``ref.chunk_agg_ref``).
    The caller normalizes once a local round or tick.  Padded tail rows
    ride along with weight 0 and assignment 0."""
    if not chunk_flat.is_cuda:
        return ref.chunk_agg_ref(chunk_flat, weights, rsu_assign, n_rsus,
                                 into=into)
    _no_backward("chunk_agg", chunk_flat, weights)
    num, mass = _mha.scatter_accumulate(chunk_flat, weights, rsu_assign,
                                        n_rsus, entry="chunk_agg")
    if into is None:
        return num, mass
    return (into[0].add_(num.to(into[0].device)),
            into[1].add_(mass.to(into[1].device)))


def cloud_agg(rsu_flat, rsu_weights) -> torch.Tensor:
    """(R, N) -> (N,) weighted mean, no keep guard."""
    if rsu_flat.is_cuda:
        _no_backward("cloud_agg", rsu_flat, rsu_weights)
        return _mha.cloud_agg(rsu_flat, rsu_weights)
    return ref.cloud_agg_ref(rsu_flat, rsu_weights)


def agg_blend(stacked_flat, weights, mask, rsu_assign, n_rsus: int, prev):
    """Fused RSU aggregation + mass guard; (rsu' in prev's dtype, mass).
    On CUDA one launch of #1's ring, or past its shared memory
    (``masked_hier_agg.ring_fits``) one of #2's agent tiles."""
    if stacked_flat.is_cuda:
        _no_backward("agg_blend", stacked_flat, weights, mask, prev)
        return _mha.agg_blend(stacked_flat, weights, mask, rsu_assign,
                              n_rsus, prev)
    return ref.agg_blend_ref(stacked_flat, weights, mask, rsu_assign, n_rsus,
                             prev)


def agg_absorb(arrivals, rsu_assign, n_rsus: int, buf, buf_mass, *,
               keep=0.0):
    """Fused multi-cohort absorb; (buf', total mass, new mass).  On CUDA
    one launch of #1's ring, or past its shared memory one of #2's agent
    tiles a cohort."""
    if buf.is_cuda:
        _no_backward("agg_absorb", buf, buf_mass, keep,
                     *(t for pair in arrivals for t in pair))
        return _mha.agg_absorb(arrivals, rsu_assign, n_rsus, buf, buf_mass,
                               keep=keep)
    return ref.agg_absorb_ref(arrivals, rsu_assign, n_rsus, buf, buf_mass,
                              keep=keep)


def cloud_blend(rsu_flat, rsu_weights, prev) -> torch.Tensor:
    """Fused cloud aggregation + keep guard; out dtype follows ``prev``."""
    if rsu_flat.is_cuda:
        _no_backward("cloud_blend", rsu_flat, rsu_weights, prev)
        return _mha.cloud_blend(rsu_flat, rsu_weights, prev)
    return ref.cloud_blend_ref(rsu_flat, rsu_weights, prev)


def _training_wait(q, v, cross: bool) -> str:
    """Which model's training on the card waits for a backward kernel that
    takes these operands, as the error's tail: whisper's cross-attention
    (T != S), deepseek-v2-lite's MLA head dims (192, 128) and
    nemotron-4-340b's (192, 192); "" for the other refusals (fp32, D =
    32), which no model's training on the card takes."""
    if cross:
        who = "whisper"
    elif v.shape[-1] != q.shape[-1]:
        who = "deepseek-v2-lite"
    elif q.shape[-1] == 192:
        who = "nemotron-4-340b"
    else:
        return ""
    return (f"; {who} training on the card waits for one (ROADMAP queue 1, "
            f"the model zoo, item 11c: {who} training)")


_CALL_LOGS: List[list] = []


@contextlib.contextmanager
def logged_calls():
    """Yields a list to which each ``flash_attention`` call within appends
    ``("flash_attention", q shape, k shape, v shape, causal, window, q
    dtype)`` and each ``slstm_scan`` call ``("slstm_scan", wx shape,
    r_gates shape, r_gates dtype)``."""
    log: list = []
    _CALL_LOGS.append(log)
    try:
        yield log
    finally:
        _CALL_LOGS.remove(log)


def _note(*entry) -> None:
    for log in _CALL_LOGS:
        log.append(entry)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cross: bool = False) -> torch.Tensor:
    """Online-softmax attention; q (B,S,H,D), k (B,T,KV,D), v (B,T,KV,Dv)
    (MLA: D = 192, Dv = 128; cross-attention, ``cross=True`` or T != S:
    non-causal, no window); out (B,S,H,Dv) in q's dtype.  On CUDA without a gradient the
    forward kernel alone (also for operands that require grad under
    ``torch.no_grad``: a no-grad prefill of trainable params saves
    nothing); with one the forward and backward kernels as one autograd
    function, and a gradient the backward kernel does not take (fp32, D =
    32 or 192, MLA's D != Dv, or a cross-attention) raises rather than
    come back without one."""
    if _CALL_LOGS:
        _note("flash_attention", tuple(q.shape), tuple(k.shape),
              tuple(v.shape), causal, window, q.dtype)
    if q.is_meta:
        return q.new_empty(tuple(q.shape[:3]) + (v.shape[-1],))
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if not _needs_grad(q, k, v):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   cross=cross)
    cross = cross or v.shape[1] != q.shape[1]
    if cross or not _fa.backward_supported(q, v):
        raise NotImplementedError(
            f"flash_attention: the backward kernel takes bf16 self-attention "
            f"with one head dim in {_fa.BWD_HEAD_DIMS}, got {q.dtype} head "
            f"dims {q.shape[-1]} / {v.shape[-1]}, {q.shape[1]} queries over "
            f"{v.shape[1]} keys{', cross-attention' if cross else ''}"
            f"{_training_wait(q, v, cross)}")
    return _fa.FlashAttention.apply(q, k, v, causal, window)


def slstm_scan(wx, r_gates, b_gates) -> torch.Tensor:
    """Forward sLSTM recurrence; wx (B,S,4d) fp32, r_gates (H,P,4P), b_gates
    (4d,) fp32; hidden states (B,S,d) fp32.  The CUDA kernel has no
    backward: a CUDA call that needs a gradient raises."""
    if _CALL_LOGS:
        _note("slstm_scan", tuple(wx.shape), tuple(r_gates.shape),
              r_gates.dtype)
    if wx.is_meta:
        return wx.new_empty(tuple(wx.shape[:2]) + (wx.shape[2] // 4,))
    if not wx.is_cuda:
        return ref.slstm_scan_ref(wx, r_gates, b_gates)
    _no_backward("slstm_scan", wx, r_gates, b_gates,
                 wait="; xlstm training on the card waits for one (ROADMAP "
                      "queue 1, xlstm-125m training)")
    return _ss.slstm_scan(wx, r_gates, b_gates)


def dual_proximal_sgd_tree(w, g, a1, a2, *, lr: float, mu1: float,
                           mu2: float):
    """Eq. 6 leaf by leaf over params trees (``repro_torch.tree`` order),
    as ``repro.kernels.dual_proximal_sgd.dual_proximal_sgd_tree``: one
    launch (or plain call) a leaf, on the leaf raveled to one row, the
    result in the leaf's shape and dtype."""
    def one(wl, gl, x1, x2):
        flat = [t.contiguous().reshape(-1) for t in (wl, gl, x1, x2)]
        return dual_proximal_sgd(*flat, lr=lr, mu1=mu1,
                                 mu2=mu2).view(wl.shape)
    return tree.unflatten(w, [one(*t) for t in zip(
        tree.leaves(w), tree.leaves(g), tree.leaves(a1), tree.leaves(a2))])


_COUNTS = (_mha.launches, _dps.launches, _fa.launches, _ss.launches)


def launch_counts() -> dict:
    """Kernel launches so far, per wrapper entry point."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
