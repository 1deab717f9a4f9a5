"""zamba2-2.7b [hybrid] — Mamba2 blocks + weight-shared attention blocks
[arXiv:2411.15242].

54L d_model=2560 32H (GQA kv=32, head dim 80) d_ff=10240 vocab=32000
ssm_state=64.  Layout: 9 super-blocks of (shared attention+MLP block, then
6 Mamba2 blocks); the attention block's weights are shared across all 9
applications (Zamba2's parameter sharing; its per-application LoRA deltas
and concatenated embedding input are omitted, as in the JAX package).
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    mlp_type="swiglu",
    attn_impl="gqa",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4,
                  chunk_size=64),
    layout=(("zamba_super", 9),),
    shared_every=6,
)
