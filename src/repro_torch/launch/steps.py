"""Step builders (``repro/launch/steps.py``): the federated train step
(``TrainState``, ``init_train_state``, ``make_train_step``) and the serving
steps (``make_prefill_step``, ``make_serve_step``).  The steps run on
``device`` (``cuda`` when None; building one raises without a GPU) and
move their inputs there; the serving steps run without autograd.  The
input specs of the reference's dry run wait for ``launch/sharding``
(ROADMAP queue 1)."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core.h2fed import H2FedParams
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import lm_logits


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    momentum: Any        # fp32, one leaf a param leaf
    anchor_rsu: Any      # w_k  (layer-1 proximal anchor)
    anchor_cloud: Any    # w    (layer-2 proximal anchor)


def train_state(params) -> TrainState:
    """A fresh state around ``params``: zero momentum, and both anchors
    copies of the params (the reference aliases them, which is safe only
    for immutable arrays)."""
    def copy():
        return tree.map_tree(lambda l: l.detach().clone(), params)
    zeros = tree.map_tree(lambda l: torch.zeros(
        l.shape, dtype=torch.float32, device=l.device), params)
    return TrainState(params=params, momentum=zeros, anchor_rsu=copy(),
                      anchor_cloud=copy())


def init_train_state(cfg: ArchConfig, gen: torch.Generator, *,
                     device=None) -> TrainState:
    """Random params from ``gen`` on ``device`` (``cuda`` when None)."""
    return train_state(M.init_params(cfg, gen, device=device))


def make_train_step(cfg: ArchConfig, hp: H2FedParams, beta: float = 0.9, *,
                    device=None):
    """The federated train step: the CSR-masked mean of the agents' losses,
    its gradient, and the dual-proximal momentum update of every leaf.

    The update is the reference's, outside any kernel: in fp32,
    ``m' = beta m + g + mu1 (w - a1) + mu2 (w - a2)`` and ``w' = w - lr m'``
    cast back to the leaf's dtype (round to nearest even).  It runs leaf by
    leaf and out of place, so the peak holds the fp32 temporaries of one
    leaf; the state handed in is left as it is."""
    dev = resolve_device(device)
    aux_w = M.aux_weight(cfg)

    def train_step(state: TrainState, batch: Dict[str, Any], mask):
        """batch leaves: (A, b, ...); mask: (A,) float connectivity.
        Returns (new state, {"loss", "aux"})."""
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        mf = torch.as_tensor(mask).to(dev).float()
        A, b = batch["tokens"].shape[:2]
        leaves = [l.detach().requires_grad_() for l in
                  tree.leaves(state.params)]
        params = tree.unflatten(state.params, leaves)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in batch.items()}
        with torch.enable_grad():
            nll, aux = M.per_example_loss(cfg, params, flat)
            per_agent = nll.reshape(A, b).mean(dim=1)
            loss = (per_agent * mf).sum() / mf.sum().clamp(min=1.0)
            grads = torch.autograd.grad(loss + aux_w * aux, leaves)
        new_p, new_m = [], []
        for w, m, g, a1, a2 in zip(
                tree.leaves(state.params), tree.leaves(state.momentum),
                grads, tree.leaves(state.anchor_rsu),
                tree.leaves(state.anchor_cloud)):
            wf = w.detach().float()
            gf = (g.float() + hp.mu1 * (wf - a1.float())
                  + hp.mu2 * (wf - a2.float()))
            m_new = beta * m + gf
            new_p.append((wf - hp.lr * m_new).to(w.dtype))
            new_m.append(m_new)
        new_state = TrainState(
            params=tree.unflatten(state.params, new_p),
            momentum=tree.unflatten(state.momentum, new_m),
            anchor_rsu=state.anchor_rsu, anchor_cloud=state.anchor_cloud)
        return new_state, {"loss": loss.detach(), "aux": aux.detach()}

    return train_step


# --------------------------------------------------------------------------
# prefill / serve steps
# --------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, *, device=None):
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        """The next-token logits (B, V) fp32 after the prompt.  The head is
        applied to the last position only: the same values as the JAX
        step's ``logits[:, -1, :]``, without its (B, S, V) fp32 logits
        (about 20 GB at B=4, S=8192 for qwen3-0.6b).  ``batch`` holds
        ``tokens`` and, by the config's front end, ``patch_embeds`` (a
        VLM) or ``memory`` (an audio model's encoder frames)."""
        batch = {k: v.to(dev) for k, v in batch.items()}
        x, _ = M.hidden_states(cfg, params, batch)
        return lm_logits(cfg, params["embed"], x[:, -1:])[:, 0]
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, device=None):
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, cache, tokens, cur_pos, memory=None):
        """One decode step: (logits (B, V) fp32, cache updated in place);
        ``memory``: an audio model's encoder frames (B, M, d_embed)."""
        logits, cache = M.decode_step(
            cfg, params, cache, tokens.to(dev), cur_pos.to(dev),
            memory=None if memory is None else memory.to(dev))
        return logits[:, -1, :], cache
    return serve_step
