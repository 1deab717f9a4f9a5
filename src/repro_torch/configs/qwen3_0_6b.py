"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B (family card)].

28L d_model=1024 16H (GQA kv=8, head_dim=128) d_ff=3072 vocab=151936.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    mlp_type="swiglu",
    attn_impl="gqa",
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
