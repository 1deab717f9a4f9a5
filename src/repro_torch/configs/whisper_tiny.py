"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

4L d_model=384 6H d_ff=1536 vocab=51865.  The mel-spectrogram + conv encoder
frontend is a stub, as in the JAX package: the caller hands 1500 encoder
frame embeddings of width 384 to the decoder as its cross-attention
memory (``batch["memory"]``).  The decoder backbone (self-attn + cross-attn
+ GELU MLP, learned positions, layernorm, biases) is implemented.
max_seq_len is the JAX package's (32768, beyond Whisper's 448-token decoder
context), so the learned position table has its shape.
"""
from repro_torch.models.config import ArchConfig, EncoderStub

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    mlp_type="gelu",
    mlp_bias=True,
    attn_impl="gqa",
    attn_bias=True,
    pos_embed="learned",
    norm_type="layernorm",
    tie_embeddings=True,
    max_seq_len=32768,
    layout=(("encdec", 4),),
    encoder=EncoderStub(kind="audio", n_positions=1500, d_embed=384),
)
