"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8, head_dim=128) expert d_ff=2048 vocab=163840,
MoE 384 routed experts top-8 + 1 shared expert.  Its 1.04e12 parameters
do not fit one card: the full config is counted on the meta device and
run reduced.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    source="arXiv:2501.kimi2",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    attn_impl="gqa",
    moe=MoEConfig(n_experts=384, top_k=8, n_shared=1, expert_d_ff=2048,
                  capacity_factor=1.25, group_size=2048),
)
