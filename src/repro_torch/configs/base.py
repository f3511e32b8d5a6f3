"""Config schema, copied from the reference package's ``configs/base.py``.

One ``ModelConfig`` dataclass covers every architecture family of the
reference; architecture files under ``repro_torch/configs/`` export
``CONFIG`` (the published dims) and ``REDUCED`` (a structurally-identical
small config for CPU tests).  Ported so far: the dense family
(``qwen1_5_4b``, ``glm4_9b``) and the MoE family (``olmoe_1b_7b``,
``deepseek_v2_236b``).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, replace

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0             # routed experts (0 = dense MLP)
    num_shared_experts: int = 0
    experts_per_token: int = 0       # top-k
    d_ff_expert: int = 0             # expert hidden size (d_ff used if 0)
    first_k_dense: int = 0           # leading dense layers (deepseek-v2 style)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25    # MoE dispatch capacity (drops above)

    # --- MLA (deepseek-v2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64          # decoupled RoPE dim per head (MLA)
    v_head_dim: int = 0              # value head dim for MLA (head_dim if 0)

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0               # N, state size per head (0 = no ssm)
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_chunk: int = 256             # SSD chunk length
    ssm_conv: int = 4                # causal conv width
    ssm_groups: int = 1              # B/C groups

    # --- hybrid (zamba2) -----------------------------------------------------
    attn_every: int = 0              # shared attn+MLP block every k ssm layers
    shared_block: bool = False       # the attn block's weights are shared

    # --- attention details ---------------------------------------------------
    sliding_window: int = 0          # 0 = full attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # precomputed frame embeddings (stub frontend)

    # --- vlm (llava) ----------------------------------------------------------
    embeds_input: bool = False       # input_specs feeds embeddings, not token ids
    num_image_tokens: int = 0        # anyres patch tokens prepended (stub)

    # --- common ---------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-time knobs (per-arch defaults; launcher may override)
    remat: bool = True
    scan_layers: bool = True
    microbatch: int = 1              # grad-accumulation factor

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.use_mla and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.num_experts and self.d_ff_expert == 0:
            object.__setattr__(self, "d_ff_expert", self.d_ff)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context (500k) decode is tractable: SSM state,
        hybrid with shared attn over bounded window, or sliding-window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A structurally-identical tiny config for CPU smoke tests."""
        small = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(4, (4 * self.num_kv_heads) // max(self.num_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.num_experts:
            small.update(num_experts=8, experts_per_token=min(self.experts_per_token, 2),
                         d_ff_expert=64,
                         num_shared_experts=min(self.num_shared_experts, 1),
                         first_k_dense=min(self.first_k_dense, 1),
                         # drop-free dispatch so tiny-batch smoke tests get
                         # exact prefill/decode parity
                         capacity_factor=8.0)
        if self.use_mla:
            small.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                         v_head_dim=32)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.attn_every:
            small.update(attn_every=2, num_layers=4)
        if self.is_encoder_decoder:
            small.update(encoder_layers=2, encoder_seq=16)
        if self.sliding_window:
            small.update(sliding_window=16)
        if self.num_image_tokens:
            small.update(num_image_tokens=8)
        small.update(overrides)
        return replace(self, **small)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# public (CLI) ids use dashes; module names use underscores
def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch)}")
    return mod.CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(arch)}")
    return getattr(mod, "REDUCED", None) or mod.CONFIG.reduced()
