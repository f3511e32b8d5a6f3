"""GLM-4-9B [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552, RoPE, QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,
)

REDUCED = CONFIG.reduced(num_kv_heads=1)
