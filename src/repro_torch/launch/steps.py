"""Serving step builders (``repro/launch/steps.py``, ``make_prefill_step``
and ``make_serve_step``).  The steps run on ``device`` (``cuda`` when None;
building one raises without a GPU), move their token inputs there and run
without autograd.  The federated train step is not ported yet (ROADMAP
queue 1, the LLM training path)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import lm_logits


def make_prefill_step(cfg: ArchConfig, *, device=None):
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        """The next-token logits (B, V) fp32 after the prompt.  The head is
        applied to the last position only: the same values as the JAX
        step's ``logits[:, -1, :]``, without its (B, S, V) fp32 logits
        (about 20 GB at B=4, S=8192 for qwen3-0.6b)."""
        batch = {k: v.to(dev) for k, v in batch.items()}
        x = M.hidden_states(cfg, params, batch)
        return lm_logits(cfg, params["embed"], x[:, -1:])[:, 0]
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, device=None):
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, cache, tokens, cur_pos):
        """One decode step: (logits (B, V) fp32, cache updated in place)."""
        logits, cache = M.decode_step(cfg, params, cache, tokens.to(dev),
                                      cur_pos.to(dev))
        return logits[:, -1, :], cache
    return serve_step
