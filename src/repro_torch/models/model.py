"""Top-level model (``repro/models/model.py``) for text-only configs:
embeddings + block stack + LM head; loss and KV-cache decode.

Params are the JAX tree's structure as dicts and lists of tensors:
``{"embed": {"tok"}, "final_norm": {"scale"}, "stack": {"segments":
[...]}}``, so a JAX checkpoint or params tree maps leaf by leaf in JAX's
leaf order (``repro_torch.tree``).  The VLM and audio front ends are not
ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from math import prod
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed_tokens, embedding_init,
                                       lm_logits, norm_apply, norm_init)


def _check_text_only(cfg: ArchConfig) -> None:
    if cfg.encoder.kind != "none":
        raise NotImplementedError(
            f"the {cfg.encoder.kind} front end of {cfg.name} is not ported "
            f"to PyTorch yet (ROADMAP queue 1, the model zoo)")


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random params on ``device`` (``cuda`` when None; raises without a
    GPU), drawn from ``gen``, which must lie on that device."""
    _check_text_only(cfg)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, params "
                         f"on {dev}")
    return {
        "embed": embedding_init(cfg, gen),
        "stack": tf.stack_init(cfg, gen),
        "final_norm": norm_init(cfg, cfg.d_model, device=gen.device),
    }


def hidden_states(cfg: ArchConfig, params, batch: Dict[str, Any]):
    """(the final-normed hidden states (B, S, d) of a token batch, the
    summed MoE load-balance loss: an fp32 scalar, 0 without MoE)."""
    _check_text_only(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[-1], device=tokens.device)
    x, aux = tf.stack_prefill(cfg, params["stack"], x, positions)
    return norm_apply(cfg, params["final_norm"], x), aux


def forward(cfg: ArchConfig, params, batch: Dict[str, Any]):
    """Full-sequence forward.  Returns (fp32 logits (B, S, V), aux), aux
    the layers' summed MoE load-balance loss (0 without MoE)."""
    x, aux = hidden_states(cfg, params, batch)
    return lm_logits(cfg, params["embed"], x), aux


def _nll(cfg: ArchConfig, params, batch: Dict[str, Any]):
    """(next-token NLL (B, S) fp32, valid-label mask (B, S), aux)."""
    logits, aux = forward(cfg, params, batch)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return nll, labels >= 0, aux


def aux_weight(cfg: ArchConfig) -> float:
    """The MoE load-balance loss's weight in the loss (0 without MoE)."""
    return cfg.moe.router_aux_weight if cfg.moe is not None else 0.0


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, Any]):
    """Mean next-token cross-entropy over valid labels (labels >= 0), plus
    ``router_aux_weight`` times the MoE aux loss."""
    nll, valid, aux = _nll(cfg, params, batch)
    task = (nll * valid).sum() / valid.sum().clamp(min=1)
    return task + aux_weight(cfg) * aux, {"task_loss": task,
                                           "aux_loss": aux}


def per_example_loss(cfg: ArchConfig, params, batch: Dict[str, Any]):
    """Per-example mean NLL (B,) and the MoE aux loss: the federated train
    step weights the NLL per agent and adds ``router_aux_weight * aux``
    (the reference's ``per_example_loss`` returns the two apart too)."""
    nll, valid, aux = _nll(cfg, params, batch)
    return (nll * valid).sum(-1) / valid.sum(-1).clamp(min=1), aux


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device=None):
    return tf.stack_init_cache(cfg, batch, cache_len,
                               device=resolve_device(device))


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_pos):
    """One decode step.  tokens: (B, 1); cur_pos: (B,).  Returns (fp32
    logits (B, 1, V), cache); the cache is updated in place."""
    _check_text_only(cfg)
    x = embed_tokens(cfg, params["embed"], tokens,
                     cur_pos[:, None] if cfg.pos_embed == "learned" else None)
    x, cache = tf.stack_decode(cfg, params["stack"], cache, x, cur_pos)
    x = norm_apply(cfg, params["final_norm"], x)
    return lm_logits(cfg, params["embed"], x), cache


# --------------------------------------------------------------------------
# analytic parameter counts (shapes on the meta device: nothing allocated)
# --------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A generator the initialisers read as lying on the meta device, so
    ``init_params`` builds shapes and dtypes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@functools.lru_cache(maxsize=64)
def _param_paths(cfg: ArchConfig):
    """(path, shape) of every leaf of ``init_params(cfg)``, built on the
    meta device."""
    params = init_params(cfg, _MetaGenerator(), device="meta")
    return tuple((path, tuple(leaf.shape))
                 for path, leaf in tree.leaves_with_paths(params))


def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count of ``init_params(cfg)``, built on the meta
    device.  ``active_only`` scales each routed expert leaf (``w_gate`` /
    ``w_up`` / ``w_down`` outside ``shared``, with an E axis) by ``top_k /
    n_experts``, as the reference does."""
    total = 0
    for path, shape in _param_paths(cfg):
        n = prod(shape)
        if (active_only and cfg.moe is not None
                and any(w in path for w in ("w_gate", "w_up", "w_down"))
                and "shared" not in path and cfg.moe.n_experts in shape):
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total
