"""Mamba2-780m [arXiv:2405.21060; unverified].

48L d_model=1536 attention-free, vocab=50280, SSD with state N=128,
head dim P=64, expand 2 (d_inner=3072, 48 ssm heads), chunk 256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,
    d_ff=0,                   # attention-free, no FFN block (Mamba2 pure stack)
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv=4,
    tie_embeddings=True,
)

REDUCED = CONFIG.reduced(num_heads=0, num_kv_heads=0, d_ff=0)
