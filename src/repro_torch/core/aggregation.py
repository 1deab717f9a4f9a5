"""Hierarchical CSR-masked weighted aggregation algebra (paper Alg. 2
l.8, Alg. 3 l.6) on torch tensors.

Weights are data-volume weights masked by connectivity; aggregation
renormalizes over the surviving mass, so a partial cohort still gives a
convex combination.  These functions build the small ``(R, A)`` weight
matrices and ``(R,)`` masses the kernels consume; the ``(A, N)`` work is
the kernels'.  Per-RSU sums are row sums of the one-hot ``(R, A)`` matrix,
not ``index_add_``: atomics on the card sum in a different order each run.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalized_weights(weights: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked weights normalized to sum 1, uniform on zero mass.
    Returns (wn (A,), mass scalar)."""
    w = weights.float()
    if mask is not None:
        w = w * mask.float()
    mass = w.sum()
    safe = torch.where(mass > 0, mass, torch.ones_like(mass))
    wn = torch.where(mass > 0, w / safe, torch.full_like(w, 1.0 / w.shape[0]))
    return wn, mass


def unnormalized_weight_matrix(weights: torch.Tensor, mask: torch.Tensor,
                               rsu_assign: torch.Tensor,
                               n_rsus: int) -> torch.Tensor:
    """Cohort-masked (R, A) weight matrix before row normalization: zero
    outside each RSU's cohort, mask_a * w_a inside."""
    w = weights.float() * mask.float()
    rsus = torch.arange(n_rsus, device=rsu_assign.device)
    onehot = (rsu_assign[None, :] == rsus[:, None]).float()
    return onehot * w[None, :]


def cohort_mass(weights: torch.Tensor, mask: torch.Tensor,
                rsu_assign: torch.Tensor, n_rsus: int) -> torch.Tensor:
    """Surviving data mass per RSU -> (R,): the row sums of the one-hot
    weight matrix (deterministic on the card)."""
    return unnormalized_weight_matrix(weights, mask, rsu_assign,
                                      n_rsus).sum(dim=1)


def build_weight_matrix(weights: torch.Tensor, mask: torch.Tensor,
                        rsu_assign: torch.Tensor,
                        n_rsus: int) -> torch.Tensor:
    """Row-normalized (R, A) masked weight matrix; rows with zero mass are
    all zero (the caller keeps those RSUs' previous model)."""
    wm = unnormalized_weight_matrix(weights, mask, rsu_assign, n_rsus)
    mass = wm.sum(dim=1, keepdim=True)
    return wm / torch.where(mass > 0, mass, torch.ones_like(mass))


def scatter_accumulate(stacked: torch.Tensor, weights: torch.Tensor,
                       rsu_assign: torch.Tensor, n_rsus: int,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized per-RSU sums: num[r] = sum_{a in r} w_a x_a (R, N),
    mass[r] = sum_{a in r} w_a (R,).  A plain reference (``index_add_``)
    for the async absorb's plain version."""
    w = weights.float()
    mass = torch.zeros(n_rsus, dtype=torch.float32, device=w.device)
    mass.index_add_(0, rsu_assign, w)
    num = torch.zeros((n_rsus, stacked.shape[1]), dtype=torch.float32,
                      device=w.device)
    num.index_add_(0, rsu_assign, stacked.float() * w[:, None])
    return num, mass


def normalize_blend(num: torch.Tensor, mass: torch.Tensor,
                    prev: torch.Tensor) -> torch.Tensor:
    """out[r] = num[r] / mass[r] where mass[r] > 0, else prev[r]; out
    dtype follows ``prev``."""
    safe = torch.where(mass > 0, mass, torch.ones_like(mass))[:, None]
    out = torch.where((mass > 0)[:, None], num.float() / safe, prev.float())
    return out.to(prev.dtype)


def buffer_absorb(buf: torch.Tensor, buf_mass: torch.Tensor,
                  num: torch.Tensor, new_mass: torch.Tensor, *, keep=0.0,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge accumulated arrivals into a staleness buffer:
    buf' = (keep*M*buf + num) / (keep*M + new_mass), rows with zero total
    mass keep ``buf``.  Returns (buf' in buf's dtype, total mass (R,))."""
    retained = (torch.as_tensor(keep, dtype=torch.float32,
                                device=buf.device) * buf_mass.float())
    total = retained + new_mass.float()
    safe = torch.where(total > 0, total, torch.ones_like(total))[:, None]
    merged = (retained[:, None] * buf.float() + num) / safe
    out = torch.where((total > 0)[:, None], merged, buf.float())
    return out.to(buf.dtype), total
