"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    arch_type="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    mlp_type="swiglu",
    attn_impl="gqa",
    rope_theta=8_000_000.0,
)
