"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

60L d_model=5120 128H MLA (kv_lora=512, q_lora=1536, decoupled rope 64,
nope head 128, v head 128), expert d_ff=1536, vocab=102400,
2 shared + 160 routed experts top-6, first layer dense (d_ff=12288).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: heads share the compressed KV; kept for bookkeeping
    head_dim=128,              # nope head dim
    d_ff=12288,                # dense-layer FFN width (first_k_dense layers)
    d_ff_expert=1536,
    vocab_size=102400,
    num_experts=160,
    num_shared_experts=2,
    experts_per_token=6,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    microbatch=2,
)

REDUCED = CONFIG.reduced()
