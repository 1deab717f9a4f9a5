"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE [arXiv:2405.04434].

27L d_model=2048 16H, MLA kv_lora=512 (+64 decoupled-RoPE dims), MoE with 64
routed experts top-6 + 2 shared experts, per-expert d_ff=1408, vocab=102400.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attn_impl="mla",
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, q_head_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, expert_d_ff=1408,
                  capacity_factor=1.25, group_size=2048),
)
