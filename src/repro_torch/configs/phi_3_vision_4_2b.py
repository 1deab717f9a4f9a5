"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision stub.

[hf:microsoft/Phi-3-vision-128k-instruct]: 32L d_model=3072 32H (GQA kv=32,
head dim 96) d_ff=8192 vocab=32064.  The vision frontend (CLIP ViT-L/14 +
projector input) is a stub, as in the JAX package: the caller hands 576
patch embeddings of width 1024 (``batch["patch_embeds"]``); the projector
linear and the full language backbone are implemented.
"""
from repro_torch.models.config import ArchConfig, EncoderStub

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    attn_impl="gqa",
    rope_theta=10_000.0,
    encoder=EncoderStub(kind="vision", n_positions=576, d_embed=1024),
)
