"""OLMoE-1B-7B [arXiv:2409.02060; hf].

16L d_model=2048 16H (MHA, kv=16) expert d_ff=1024 vocab=50304,
MoE 64 experts top-8.  ~1B active / ~7B total params.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                # expert hidden size
    d_ff_expert=1024,
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    microbatch=1,
)

REDUCED = CONFIG.reduced()
