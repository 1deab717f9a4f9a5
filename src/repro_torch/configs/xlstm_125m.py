"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H d_ff=0 (blocks carry their own projections) vocab=50304.
Layout: 3 mLSTM blocks then 1 sLSTM block, repeated (9 mLSTM : 3 sLSTM).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attn_impl="none",
    pos_embed="none",
    tie_embeddings=True,
    layout=(("mlstm", 3), ("slstm", 1),
            ("mlstm", 3), ("slstm", 1),
            ("mlstm", 3), ("slstm", 1)),
    # chunkwise-parallel mLSTM prefill; the reduced config keeps the
    # per-step form (models/config.reduced sets mlstm_chunk=0)
    mlstm_chunk=128,
)
