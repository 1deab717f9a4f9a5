"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    arch_type="dense",
    source="arXiv:2403.04652",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp_type="swiglu",
    attn_impl="gqa",
    rope_theta=5_000_000.0,
)
