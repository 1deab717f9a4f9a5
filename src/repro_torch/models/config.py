"""Architecture configuration, a copy of ``repro/models/config.py`` that
imports no JAX.

One frozen dataclass describes every architecture family; ``layout_`` is
the list of (pattern, repeat) segments of the layer stack.  The port runs
the ``decoder`` pattern (GQA or MLA attention, an MLP or the MoE layer),
the Mamba-2 and xLSTM patterns and the ``zamba_super`` hybrid; the
sub-configs of the other families are kept so that a config of any family
can be described and refused by name (``models/transformer``).  ``activation_dtype`` and ``weight_dtype`` are
torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    group_size: int = 2048
    router_aux_weight: float = 0.01
    dispatch_impl: str = "einsum"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    chunk_size: int = 64


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    q_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderStub:
    kind: str = "none"              # "vision" | "audio" | "none"
    n_positions: int = 0
    d_embed: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0

    attn_impl: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_window: int = 0            # 0 = full causal; >0 = sliding window
    attn_bias: bool = False
    attn_chunk: int = 1024          # the JAX prefill's KV chunk (unused here)
    pos_embed: str = "rope"         # rope | learned | none

    mlp_type: str = "swiglu"        # swiglu | squared_relu | gelu
    mlp_bias: bool = False
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: EncoderStub = EncoderStub()

    layout: Tuple[Tuple[str, int], ...] = ()
    shared_every: int = 0
    mlstm_chunk: int = 0
    shard_strategy: str = "fsdp_tp"

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    max_seq_len: int = 1 << 20

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(
            self.n_heads, 1)

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def weight_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def layout_(self) -> Tuple[Tuple[str, int], ...]:
        if self.layout:
            return self.layout
        return (("decoder", self.n_layers),)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 256,
            n_heads: int = 4, n_kv_heads: int = 2, d_ff: int = 512,
            vocab_size: int = 512, n_experts: int = 4, top_k: int = 2,
            seq_len_cap: int = 128) -> ArchConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512, <=4
    experts (the JAX package's rule, line for line)."""
    kw = dict(
        n_layers=n_layers, d_model=d_model, n_heads=n_heads,
        n_kv_heads=min(n_kv_heads, cfg.n_kv_heads or n_kv_heads) or n_kv_heads,
        d_ff=d_ff if cfg.d_ff else 0, vocab_size=vocab_size, head_dim=0,
        max_seq_len=seq_len_cap, mlstm_chunk=0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(n_experts, cfg.moe.n_experts),
            top_k=min(top_k, cfg.moe.top_k), expert_d_ff=d_ff // 2,
            group_size=32, n_shared=min(cfg.moe.n_shared, 1))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                        chunk_size=16)
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(cfg.mla, kv_lora_rank=64,
                                        rope_head_dim=16, q_head_dim=32,
                                        v_head_dim=32)
    if cfg.encoder.kind != "none":
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_positions=16,
                                            d_embed=d_model)
    if cfg.layout:
        seen, new_layout = set(), []
        for pat, rep in cfg.layout:
            r = 1 if pat in seen else min(rep, 2)
            seen.add(pat)
            new_layout.append((pat, r))
        kw["layout"] = tuple(new_layout)
    if cfg.attn_window:
        kw["attn_window"] = 32
    kw["attn_chunk"] = 32
    return cfg.replace(**kw)
