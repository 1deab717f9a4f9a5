"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="squared_relu",
    attn_impl="gqa",
    rope_theta=10_000.0,
)
