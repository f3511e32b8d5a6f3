"""Deterministic synthetic data pipeline.

The port of the reference's ``data/pipeline.py``.  Tokens are a pure
function of (seed, step, position), a counter-mode hash (splitmix-style)
with no state to checkpoint, so a restarted job regenerates exactly the
batches it would have seen: the property the fault-tolerant loop's
resume relies on (``train/loop.py``).  Every batch is made with numpy on
the host, bit-equal to the reference's, and moved to the device once.
On a process mesh (``mesh``, ``batch_spec``: the batch dim's spec, the
data axis in ``train/loop.py::_batch_spec``) each rank builds only its
own rows, as the reference's per-device callback does: the same rows,
bit-equal, as the one-rank batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.sharding.rules import P, shard_index


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


# Width of the random-walk step.  Tokens are a cumulative sum of small
# hashed deltas, so sequences carry learnable next-token structure (the
# conditional entropy is log2(WALK_DELTAS) bits, far below log2(vocab)),
# which the loss-decrease tests need, while staying a pure counter-mode
# function of (seed, step, index, position) for deterministic replay.
WALK_DELTAS = 8


def synth_tokens(seed: int, step: int, index, seq: int, vocab: int) -> np.ndarray:
    """index: (b,) global batch indices -> (b, seq) int32 tokens."""
    b = np.asarray(index, np.uint64)[:, None]
    pos = np.arange(seq, dtype=np.uint64)[None, :]
    key = (np.uint64(seed) << np.uint64(40)) ^ (np.uint64(step) << np.uint64(20))
    h = _splitmix(b * np.uint64(1_000_003) + pos + key)
    deltas = (h % np.uint64(WALK_DELTAS)).astype(np.int64)
    start = (_splitmix(b * np.uint64(7_368_787) + key) % np.uint64(vocab)
             ).astype(np.int64)
    walk = (start + np.cumsum(deltas, axis=1)) % np.int64(vocab)
    return walk.astype(np.int32)


def _wave(base: np.ndarray, period: int, d: int) -> np.ndarray:
    """(b, n) hashed ints -> (b, n, d) fp32 values in [-0.5, 0.5), each
    position's value repeated over the width, as the reference's."""
    return (base[..., None] % period / period - 0.5).repeat(
        d, axis=-1).astype(np.float32)


@dataclasses.dataclass
class SyntheticData:
    """Batches of ``shape`` (``global_batch`` x ``seq_len``) for ``cfg``,
    a function of (``seed``, step) only, on ``device``.

    ``batch(step)`` holds ``tokens`` and ``labels`` (the next tokens; a
    VLM's sequence starts with its ``num_image_tokens`` image positions,
    whose labels are -100, and only the rest are tokens), int32; a VLM's
    ``embeds`` (b, num_image_tokens, d_model) and an encoder-decoder's
    ``enc_frames`` (b, encoder_seq, d_model), fp32.  With a process
    ``mesh``, b is this rank's rows under ``batch_spec``."""
    cfg: ModelConfig
    shape: ShapeSpec
    seed: int = 17
    device: str = "cuda"
    mesh: Optional[object] = None
    batch_spec: P = P(None)

    def rows(self) -> np.ndarray:
        """The global batch rows this rank builds."""
        b = self.shape.global_batch
        entry = self.batch_spec[0] if self.mesh is not None else None
        i, n = shard_index(entry, self.mesh, getattr(self.mesh, "coords",
                                                     None))
        if b % n:
            raise ValueError(f"a global batch of {b} does not split over "
                             f"{entry} ({n} ranks)")
        w = b // n
        return np.arange(i * w, (i + 1) * w)

    def batch(self, step: int) -> dict:
        cfg, sp = self.cfg, self.shape
        s = sp.seq_len
        rows = self.rows()
        b = len(rows)
        n_img = cfg.num_image_tokens if cfg.embeds_input else 0
        toks = synth_tokens(self.seed, step, rows, s - n_img + 1,
                            cfg.vocab_size)
        labels = toks[:, 1:]
        if n_img:
            labels = np.concatenate(
                [np.full((b, n_img), -100, np.int32), labels], axis=1)
        out = {"tokens": toks[:, :-1], "labels": labels}
        if cfg.embeds_input:
            base = synth_tokens(self.seed, step + 7_777, rows, n_img, 1 << 16)
            out["embeds"] = _wave(base.astype(np.float32), 97, cfg.d_model)
        if cfg.is_encoder_decoder:
            base = synth_tokens(self.seed, step + 3_333, rows,
                                cfg.encoder_seq, 1 << 16)
            out["enc_frames"] = _wave(base.astype(np.float32), 89,
                                      cfg.d_model)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in out.items()}
