"""Proximal-aware SGD (+ momentum) on params trees (``repro/optim/sgd.py``).

The H2-Fed penalty gradient is closed form (mu1 (w - w_k) + mu2 (w - w)),
so the optimizer takes the two anchors directly instead of differentiating
the penalty.  Trees are the port's nested dicts and lists of tensors
(``repro_torch.tree``); the math is fp32 and each new leaf is cast back to
its leaf's dtype (round to nearest even).  Updates are out of place: the
params, grads and anchors handed in are left as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree

PyTree = Any


def global_norm(t: PyTree) -> torch.Tensor:
    """fp32 L2 norm over every leaf."""
    return torch.sqrt(sum(l.float().square().sum() for l in tree.leaves(t)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Scale grads so their global L2 norm is at most ``max_norm``."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
    return tree.map_tree(lambda g: (g.float() * scale).to(g.dtype), grads)


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.05
    momentum: float = 0.0       # 0 = plain SGD (the paper's Alg. 1)
    weight_decay: float = 0.0


class SGDState(NamedTuple):
    momentum: Optional[PyTree]


def init(cfg: SGDConfig, params: PyTree) -> SGDState:
    if cfg.momentum:
        return SGDState(tree.map_tree(
            lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                  device=l.device), params))
    return SGDState(None)


def step(cfg: SGDConfig, params: PyTree, grads: PyTree, state: SGDState,
         *, anchors: Tuple[Tuple[float, PyTree], ...] = ()
         ) -> Tuple[PyTree, SGDState]:
    """params <- params - lr (g + sum_l mu_l (params - anchor_l) + wd params),
    through the momentum buffer when ``cfg.momentum``."""
    mus = [m for m, _ in anchors]
    anc = [tree.leaves(a) for _, a in anchors]
    ws, gs = tree.leaves(params), tree.leaves(grads)

    def eff_grad(i):
        wf = ws[i].float()
        gf = gs[i].float()
        for mu, a in zip(mus, anc):
            gf = gf + mu * (wf - a[i].float())
        if cfg.weight_decay:
            gf = gf + cfg.weight_decay * wf
        return wf, gf

    new_p, new_m = [], []
    ms = (tree.leaves(state.momentum)
          if cfg.momentum and state.momentum is not None else None)
    for i, w in enumerate(ws):
        wf, gf = eff_grad(i)
        if ms is not None:
            gf = cfg.momentum * ms[i] + gf
            new_m.append(gf)
        new_p.append((wf - cfg.lr * gf).to(w.dtype))
    if ms is not None:
        return (tree.unflatten(params, new_p),
                SGDState(tree.unflatten(state.momentum, new_m)))
    return tree.unflatten(params, new_p), state
