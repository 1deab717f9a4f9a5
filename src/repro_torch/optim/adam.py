"""Proximal-aware Adam (AdamW) on params trees (``repro/optim/adam.py``).

The dual proximal pull enters the gradient before the moment updates, so
Adam sees the whole H2-Fed objective's gradient.  fp32 moments; ``count``
is an int32 tensor on the params' device and the bias corrections are
``1 - b ** count`` in fp32, as the reference computes them.  Updates are
out of place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


def init(cfg: AdamConfig, params: PyTree) -> AdamState:
    def zeros():
        return tree.map_tree(lambda l: torch.zeros(
            l.shape, dtype=torch.float32, device=l.device), params)
    dev = tree.leaves(params)[0].device
    return AdamState(mu=zeros(), nu=zeros(),
                     count=torch.zeros((), dtype=torch.int32, device=dev))


def step(cfg: AdamConfig, params: PyTree, grads: PyTree, state: AdamState,
         *, anchors: Tuple[Tuple[float, PyTree], ...] = ()
         ) -> Tuple[PyTree, AdamState]:
    count = state.count + 1
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                      device=cf.device), cf)
    mus = [m for m, _ in anchors]
    anc = [tree.leaves(a) for _, a in anchors]
    new_p, new_m, new_v = [], [], []
    for i, (w, g, m, v) in enumerate(zip(
            tree.leaves(params), tree.leaves(grads), tree.leaves(state.mu),
            tree.leaves(state.nu))):
        wf = w.float()
        gf = g.float()
        for mu_c, a in zip(mus, anc):
            gf = gf + mu_c * (wf - a[i].float())
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        upd = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * wf
        new_p.append((wf - cfg.lr * upd).to(w.dtype))
        new_m.append(m_new)
        new_v.append(v_new)
    return (tree.unflatten(params, new_p),
            AdamState(mu=tree.unflatten(state.mu, new_m),
                      nu=tree.unflatten(state.nu, new_v), count=count))
