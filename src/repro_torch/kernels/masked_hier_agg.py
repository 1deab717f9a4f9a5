"""Masked hierarchical aggregation on the card (paper Alg. 2 l.8 / Alg. 3
l.6): wrappers around the CUDA kernel ``csrc/fused_agg_blend.cu``.

One kernel serves every entry point here.  With a previous buffer it is
the fused aggregate-and-blend of ``repro.kernels.masked_hier_agg.
_fused_agg_blend``,

    out[r, n] = guard[r] ? (retained[r]*buf[r, n] + sum_i W_i[r, :] @ X_i[:, n])
                             / safe[r]
                         : buf[r, n]

(``agg_blend``: RSU layer plus mass guard; ``cloud_blend``: R -> 1 plus
keep guard into the fp32 master; ``agg_absorb``: the async tick's two
cohorts plus the retained buffer).  Without one it is the plain
``(R, A) @ (A, N)`` of ``weighted_agg_matmul`` (``masked_hier_agg`` and
``cloud_agg``, the ``fused=False`` path).  The small weight matrices and
the ``coef`` rows ``[retained | safe | guard]`` come from
``core.aggregation`` on the device; W stays fp32 and the kernel
accumulates in fp32 whatever the fleet dtype.

Every function takes CUDA tensors only and raises on anything else; the
CPU route is ``kernels/ops``' choice of ``kernels/ref``.  ``launches``
counts kernel launches per entry point.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.aggregation import (build_weight_matrix, cohort_mass,
                                          normalized_weights,
                                          unnormalized_weight_matrix)
from repro_torch.kernels import _lib

FLEET_DTYPES = (torch.float32, torch.bfloat16)
SMEM_BYTES = 232_448    # shared memory a block may opt into on sm_90

launches: Dict[str, int] = {"agg_blend": 0, "cloud_blend": 0,
                            "agg_absorb": 0, "weighted_agg_matmul": 0}


def _require(t: torch.Tensor, name: str, shape: Tuple[int, ...],
             dtypes: Sequence[torch.dtype], device: torch.device) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device} (cuda), "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(entry: str, coef: Optional[torch.Tensor],
            weight_mats: Sequence[torch.Tensor],
            stackeds: Sequence[torch.Tensor], buf: Optional[torch.Tensor],
            out: torch.Tensor) -> torch.Tensor:
    """Check every operand and launch ``repro_fused_agg_blend`` on the
    current stream; the caller allocated ``out``."""
    n_pairs = len(weight_mats)
    if n_pairs not in (1, 2) or len(stackeds) != n_pairs:
        raise ValueError(f"{entry}: want 1 or 2 (W, X) pairs")
    dev = out.device
    R, N = out.shape
    x_dtype = stackeds[0].dtype
    if R < 1 or N < 1:
        raise ValueError(f"{entry}: empty output {tuple(out.shape)}")
    _require(out, "out", (R, N), FLEET_DTYPES, dev)
    for i, (w, x) in enumerate(zip(weight_mats, stackeds)):
        a = w.shape[1] if w.dim() == 2 else -1
        if a < 1:
            raise ValueError(f"{entry}: W_{i} must be (R, A) with A >= 1")
        _require(w, f"W_{i}", (R, a), (torch.float32,), dev)
        _require(x, f"X_{i}", (a, N), (x_dtype,), dev)
    if buf is not None:
        _require(coef, "coef", (R, 3), (torch.float32,), dev)
        _require(buf, "buf", (R, N), (out.dtype,), dev)
        if out.dtype not in (x_dtype, torch.float32):
            raise ValueError(f"{entry}: out dtype {out.dtype} must be X's "
                             f"({x_dtype}) or float32")
    elif n_pairs != 1 or out.dtype != x_dtype:
        raise ValueError(f"{entry}: without a buffer the kernel takes one "
                         f"pair and writes X's dtype")
    # the kernel stages a (row chunk x agents) weight tile in shared memory
    n_agents = sum(w.shape[1] for w in weight_mats)
    row_chunk = next(c for c in (1, 2, 4, 8, 16) if c >= min(R, 16))
    if row_chunk * n_agents * 4 > SMEM_BYTES:
        raise ValueError(f"{entry}: {n_agents} agents x {row_chunk} rows of "
                         f"weights exceed {SMEM_BYTES} bytes of shared memory")
    pair2 = n_pairs == 2
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _lib.library().repro_fused_agg_blend(
        ptr(coef), weight_mats[0].data_ptr(), stackeds[0].data_ptr(),
        weight_mats[0].shape[1],
        weight_mats[1].data_ptr() if pair2 else None,
        stackeds[1].data_ptr() if pair2 else None,
        weight_mats[1].shape[1] if pair2 else 0,
        ptr(buf), out.data_ptr(), R, N,
        int(x_dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
        n_pairs, int(buf is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(rc, "fused_agg_blend")
    launches[entry] += 1
    return out


def _fused_agg_blend(coef: torch.Tensor, weight_mats, stackeds,
                     buf: torch.Tensor, *, entry: str) -> torch.Tensor:
    """out = where(guard, (retained*buf + sum_i W_i @ X_i) / safe, buf) in
    one pass; out dtype == buf dtype."""
    return _launch(entry, coef.contiguous(),
                   [w.contiguous() for w in weight_mats], list(stackeds),
                   buf, torch.empty_like(buf))


def weighted_agg_matmul(weight_matrix: torch.Tensor,
                        stacked: torch.Tensor) -> torch.Tensor:
    """(R, A) @ (A, N) with fp32 accumulation, out in the stacked dtype."""
    R, N = weight_matrix.shape[0], stacked.shape[1]
    out = torch.empty((R, N), dtype=stacked.dtype, device=stacked.device)
    return _launch("weighted_agg_matmul", None,
                   [weight_matrix.float().contiguous()], [stacked], None, out)


def masked_hier_agg(stacked_flat, weights, mask, rsu_assign, n_rsus: int):
    """RSU aggregation without the blend: (rsu (R, N), mass (R,))."""
    W = build_weight_matrix(weights, mask, rsu_assign, n_rsus)
    mass = cohort_mass(weights, mask, rsu_assign, n_rsus)
    return weighted_agg_matmul(W, stacked_flat), mass


def cloud_agg(rsu_flat, rsu_weights) -> torch.Tensor:
    """Cloud aggregation without the keep guard: (R, N) -> (N,)."""
    wn, _ = normalized_weights(rsu_weights)
    return weighted_agg_matmul(wn[None, :], rsu_flat)[0]


def agg_blend(stacked_flat, weights, mask, rsu_assign, n_rsus: int, prev):
    """Fused RSU aggregation + mass guard:
    ``out[r] = mass[r] > 0 ? W_norm[r] @ X : prev[r]``.
    Returns (rsu' (R, N) in prev's dtype, mass (R,))."""
    W = build_weight_matrix(weights, mask, rsu_assign, n_rsus)
    mass = cohort_mass(weights, mask, rsu_assign, n_rsus)
    coef = torch.stack([torch.zeros_like(mass), torch.ones_like(mass),
                        (mass > 0).float()], dim=1)
    out = _fused_agg_blend(coef, (W,), (stacked_flat,), prev,
                           entry="agg_blend")
    return out, mass


def agg_absorb(arrivals, rsu_assign, n_rsus: int, buf, buf_mass, *,
               keep=0.0):
    """Fused multi-cohort scatter-accumulate + staleness-buffer merge for
    ``arrivals`` = sequence of (x (A, N), w (A,)):
    ``out[r] = (keep*M[r]*buf[r] + sum w_a x_a) / (keep*M[r] + m_new[r])``
    (buf[r] on zero mass).  Returns (buf', total mass, new mass)."""
    mats, xs = [], []
    new_mass = torch.zeros(n_rsus, dtype=torch.float32, device=buf.device)
    for x, w in arrivals:
        wm = unnormalized_weight_matrix(w, torch.ones_like(w), rsu_assign,
                                        n_rsus)
        mats.append(wm)
        xs.append(x)
        new_mass = new_mass + wm.sum(dim=1)
    retained = (torch.as_tensor(keep, dtype=torch.float32,
                                device=buf.device) * buf_mass.float())
    retained = retained.expand(new_mass.shape)
    total = retained + new_mass
    coef = torch.stack([retained,
                        torch.where(total > 0, total,
                                    torch.ones_like(total)),
                        (total > 0).float()], dim=1)
    out = _fused_agg_blend(coef, mats, xs, buf, entry="agg_absorb")
    return out, total, new_mass


def cloud_blend(rsu_flat, rsu_weights, prev) -> torch.Tensor:
    """Fused cloud aggregation + keep guard:
    ``sum(mass) > 0 ? wn @ rsu_flat : prev``; out dtype follows ``prev``
    (the fp32 cloud master)."""
    w = rsu_weights.float()
    total = w.sum()
    wn = torch.where(total > 0,
                     w / torch.where(total > 0, total, torch.ones_like(total)),
                     torch.zeros_like(w))
    coef = torch.stack([torch.zeros_like(total), torch.ones_like(total),
                        (total > 0).float()])[None, :]
    return _fused_agg_blend(coef, (wn[None, :],), (rsu_flat,), prev[None, :],
                            entry="cloud_blend")[0]
