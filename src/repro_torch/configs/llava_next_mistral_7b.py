"""LLaVA-NeXT (v1.6) Mistral-7B backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only per the brief: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.  The anyres vision tower is a STUB, as in the reference:
the batch carries precomputed patch embeddings (576 base + anyres tiles,
``embeds``) that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    embeds_input=True,
    num_image_tokens=2880,     # anyres: 576 base + 4 tiles x 576
)

REDUCED = CONFIG.reduced()
