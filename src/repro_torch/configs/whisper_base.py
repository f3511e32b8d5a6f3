"""Whisper-base [arXiv:2212.04356; unverified].

Enc-dec, 6L encoder + 6L decoder, d_model=512 8H d_ff=2048 vocab=51865.
Conv frontend is a STUB, as in the reference: the batch carries
precomputed mel-frame embeddings (``enc_frames``, 1500 frames after the
conv stride-2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,              # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=6,
    encoder_seq=1500,
    tie_embeddings=True,
)

REDUCED = CONFIG.reduced()
