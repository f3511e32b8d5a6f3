"""Zamba2-2.7B [arXiv:2411.15242; hf].

54 Mamba2 layers d_model=2560 (state 64) + a SHARED full-attention+MLP
block (32H, d_ff=10240) applied every 6 ssm layers with shared weights.
vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    shared_block=True,
)

REDUCED = CONFIG.reduced()
