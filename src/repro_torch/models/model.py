"""Top-level model (``repro/models/model.py``): embeddings + block stack +
LM head; loss and KV-cache decode.

Params are the JAX tree's structure as dicts and lists of tensors:
``{"embed": {"tok"}, "final_norm": {"scale"}, "stack": {"segments":
[...]}}`` and, for a VLM, ``"patch_proj"``, so a JAX checkpoint or params
tree maps leaf by leaf in JAX's leaf order (``repro_torch.tree``).  The
modality front ends are the reference's stubs: a VLM's batch carries
``patch_embeds`` (B, P, d_embed), which ``patch_proj`` projects and
prepends to the token embeddings (the head drops those P positions
again); an audio model's batch carries ``memory`` (B, M, d_embed), the
encoder frames its cross-attention attends.  Both are cast to the
activation dtype.

The forward and the losses take an optional ``tp``: a
``launch.mesh.FleetMesh`` whose ``model`` group splits a ``decoder``
GQA model (``launch/sharding.ModelAxis``: the params are this rank's
shards, the config the local one).  The logits are then this rank's
vocab columns and the NLL the vocab-split cross-entropy
(``collectives.tp_cross_entropy``).  None is the unsplit model.
"""
from __future__ import annotations

import functools
from math import prod
from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.device import resolve_device
from repro_torch.launch import collectives
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dense_init, embed_tokens,
                                       embedding_init, lm_logits, norm_apply,
                                       norm_init)


def init_params(cfg: ArchConfig, gen: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random params on ``device`` (``cuda`` when None; raises without a
    GPU), drawn from ``gen``, which must lie on that device."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"init_params: generator on {gen.device}, params "
                         f"on {dev}")
    params = {
        "embed": embedding_init(cfg, gen),
        "stack": tf.stack_init(cfg, gen),
        "final_norm": norm_init(cfg, cfg.d_model, device=gen.device),
    }
    if cfg.encoder.kind == "vision":
        params["patch_proj"] = dense_init(
            gen, (cfg.encoder.d_embed, cfg.d_model), cfg.weight_dtype)
    return params


def _merge_inputs(cfg: ArchConfig, params, batch: Dict[str, Any], tp=None):
    """(the input embeddings (B, P + S, d), their positions 0..P+S-1, P):
    the token embeddings, and for a VLM the projected patch embeddings
    prepended (P of them), learned positions offset by P."""
    tokens = batch["tokens"]
    S = tokens.shape[-1]
    if cfg.encoder.kind != "vision":
        x = embed_tokens(cfg, params["embed"], tokens, tp=tp)
        return x, torch.arange(S, device=tokens.device), 0
    patches = batch["patch_embeds"].to(cfg.activation_dtype)
    pe = patches @ params["patch_proj"]
    n_p = pe.shape[1]
    positions = torch.arange(n_p + S, device=tokens.device)
    x_tok = embed_tokens(cfg, params["embed"], tokens,
                         positions[n_p:].expand(tokens.shape[0], S)
                         if cfg.pos_embed == "learned" else None)
    return torch.cat([pe, x_tok], dim=1), positions, n_p


def _memory(cfg: ArchConfig, memory):
    return None if memory is None else memory.to(cfg.activation_dtype)


def hidden_states(cfg: ArchConfig, params, batch: Dict[str, Any], tp=None):
    """(the final-normed hidden states (B, S, d) of the batch's S tokens,
    the summed MoE load-balance loss: an fp32 scalar, 0 without MoE).  A
    VLM's patch positions are dropped; an audio model attends
    ``batch["memory"]``."""
    x, positions, n_prefix = _merge_inputs(cfg, params, batch, tp)
    x, aux = tf.stack_prefill(cfg, params["stack"], x, positions,
                              _memory(cfg, batch.get("memory")), tp)
    x = norm_apply(cfg, params["final_norm"], x)
    return (x[:, n_prefix:] if n_prefix else x), aux


def forward(cfg: ArchConfig, params, batch: Dict[str, Any], tp=None):
    """Full-sequence forward.  Returns (fp32 logits (B, S, V), aux), aux
    the layers' summed MoE load-balance loss (0 without MoE); with ``tp``
    the logits of this rank's vocab columns."""
    x, aux = hidden_states(cfg, params, batch, tp)
    return lm_logits(cfg, params["embed"], x, tp), aux


def _nll(cfg: ArchConfig, params, batch: Dict[str, Any], tp=None):
    """(next-token NLL (B, S) fp32, valid-label mask (B, S), aux)."""
    logits, aux = forward(cfg, params, batch, tp)
    labels = batch["labels"].long()
    if tp is not None:
        nll = collectives.tp_cross_entropy(logits.float(),
                                           labels.clamp(min=0), tp)
        return nll, labels >= 0, aux
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return nll, labels >= 0, aux


def aux_weight(cfg: ArchConfig) -> float:
    """The MoE load-balance loss's weight in the loss (0 without MoE)."""
    return cfg.moe.router_aux_weight if cfg.moe is not None else 0.0


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, Any], tp=None):
    """Mean next-token cross-entropy over valid labels (labels >= 0), plus
    ``router_aux_weight`` times the MoE aux loss; ``tp`` as for
    ``forward``."""
    nll, valid, aux = _nll(cfg, params, batch, tp)
    task = (nll * valid).sum() / valid.sum().clamp(min=1)
    return task + aux_weight(cfg) * aux, {"task_loss": task,
                                           "aux_loss": aux}


def per_example_loss(cfg: ArchConfig, params, batch: Dict[str, Any],
                     tp=None):
    """Per-example mean NLL (B,) and the MoE aux loss: the federated train
    step weights the NLL per agent and adds ``router_aux_weight * aux``
    (the reference's ``per_example_loss`` returns the two apart too);
    ``tp`` as for ``forward``."""
    nll, valid, aux = _nll(cfg, params, batch, tp)
    return (nll * valid).sum(-1) / valid.sum(-1).clamp(min=1), aux


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device=None):
    return tf.stack_init_cache(cfg, batch, cache_len,
                               device=resolve_device(device))


def decode_step(cfg: ArchConfig, params, cache, tokens, cur_pos,
                memory=None):
    """One decode step.  tokens: (B, 1); cur_pos: (B,); memory: (B, M,
    d_embed) for an audio model.  Returns (fp32 logits (B, 1, V), cache);
    the cache is updated in place.  A VLM decodes text tokens only, as the
    reference does."""
    x = embed_tokens(cfg, params["embed"], tokens,
                     cur_pos[:, None] if cfg.pos_embed == "learned" else None)
    x, cache = tf.stack_decode(cfg, params["stack"], cache, x, cur_pos,
                               _memory(cfg, memory))
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


def meta_params(cfg: ArchConfig) -> Dict[str, Any]:
    """``init_params(cfg)``'s tree on the meta device: every leaf's shape
    and dtype, nothing allocated or drawn."""
    return init_params(cfg, _MetaGenerator(), device="meta")


@functools.lru_cache(maxsize=64)
def _param_paths(cfg: ArchConfig):
    """(path, shape, bytes an element) of every leaf of
    ``init_params(cfg)``, built on the meta device."""
    params = meta_params(cfg)
    return tuple((path, tuple(leaf.shape), leaf.element_size())
                 for path, leaf in tree.leaves_with_paths(params))


def param_bytes(cfg: ArchConfig) -> int:
    """Bytes of ``init_params(cfg)`` (each leaf in its own dtype), built on
    the meta device."""
    return sum(prod(shape) * size for _, shape, size in _param_paths(cfg))


def largest_draw_slice(cfg: ArchConfig) -> int:
    """Elements of the largest piece ``init_params(cfg)`` draws at once:
    a stacked leaf (3-D or more) is drawn one slice of its leading axis at
    a time, a 2-D or 1-D leaf whole (``layers.dense_init``)."""
    return max(prod(shape[1:]) if len(shape) > 2 else prod(shape)
               for _, shape, _ in _param_paths(cfg))


def cache_bytes(cfg: ArchConfig, batch: int, cache_len: int) -> int:
    """Bytes of ``init_cache(cfg, batch, cache_len)``, built on the meta
    device."""
    cache = tf.stack_init_cache(cfg, batch, cache_len, device="meta")
    return sum(t.numel() * t.element_size() for t in tree.leaves(cache))


def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count of ``init_params(cfg)``, built on the meta
    device.  ``active_only`` scales each routed expert leaf (``w_gate`` /
    ``w_up`` / ``w_down`` outside ``shared``, with an E axis) by ``top_k /
    n_experts``, as the reference does."""
    total = 0
    for path, shape, _ in _param_paths(cfg):
        n = prod(shape)
        if (active_only and cfg.moe is not None
                and any(w in path for w in ("w_gate", "w_up", "w_down"))
                and "shared" not in path and cfg.moe.n_experts in shape):
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n
    return total
