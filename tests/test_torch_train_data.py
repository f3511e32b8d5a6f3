"""The port's synthetic data pipeline against the reference's.

Batches are made with numpy on both sides from (seed, step, index), so
they must be bit-equal: no tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs.base import get_reduced_config as ref_reduced_config
from repro.data import pipeline as ref_pipeline
from repro_torch.configs.base import ShapeSpec, get_reduced_config
from repro_torch.data import pipeline


@pytest.mark.parametrize("seed,step", [(0, 0), (5, 3), (17, 12345),
                                       (2**20 - 1, 2**19 + 7)])
@pytest.mark.parametrize("vocab", [512, 151936])
def test_synth_tokens_bit_equal(seed, step, vocab):
    index = np.array([0, 1, 2, 7, 1023, 2**31 + 5])
    got = pipeline.synth_tokens(seed, step, index, 96, vocab)
    want = ref_pipeline.synth_tokens(seed, step, index, 96, vocab)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_splitmix_and_walk_width_are_the_reference():
    x = np.arange(0, 2**40, 2**29, dtype=np.uint64)
    np.testing.assert_array_equal(pipeline._splitmix(x),
                                  ref_pipeline._splitmix(x))
    assert pipeline.WALK_DELTAS == ref_pipeline.WALK_DELTAS


def _batches(arch, seq, b, step, seed=3):
    ref_cfg = ref_reduced_config(arch)
    cfg = get_reduced_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    want = ref_pipeline.SyntheticData(
        ref_cfg, RefShapeSpec("t", seq, b, "train"), seed=seed).batch(step)
    got = pipeline.SyntheticData(cfg, ShapeSpec("t", seq, b, "train"),
                                 seed=seed, device="cpu").batch(step)
    return cfg, got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,keys", [
    ("qwen1_5_4b", {"tokens", "labels"}),
    ("llava_next_mistral_7b", {"tokens", "labels", "embeds"}),
    ("whisper_base", {"tokens", "labels", "enc_frames"}),
])
@pytest.mark.parametrize("step", [0, 9])
def test_batches_equal_the_reference(arch, keys, step):
    cfg, got, want = _batches(arch, 24, 3, step)
    assert set(got) == set(want) == keys
    for k in keys:
        assert got[k].device.type == "cpu"
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_vlm_labels_mask_the_image_positions():
    cfg, got, _ = _batches("llava_next_mistral_7b", 24, 2, 1)
    n_img = cfg.num_image_tokens
    assert got["tokens"].shape == (2, 24 - n_img)
    assert got["embeds"].shape == (2, n_img, cfg.d_model)
    assert got["labels"].shape == (2, 24)
    assert bool((got["labels"][:, :n_img] == -100).all())
    assert bool((got["labels"][:, n_img:] >= 0).all())


def test_encdec_frames_shape():
    cfg, got, _ = _batches("whisper_base", 16, 2, 0)
    assert got["enc_frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    assert got["enc_frames"].dtype == torch.float32


def test_batches_deterministic_across_instances():
    cfg = get_reduced_config("qwen1_5_4b")
    shape = ShapeSpec("tiny", 16, 4, "train")
    d1 = pipeline.SyntheticData(cfg, shape, seed=5, device="cpu")
    d2 = pipeline.SyntheticData(cfg, shape, seed=5, device="cpu")
    assert torch.equal(d1.batch(3)["tokens"], d2.batch(3)["tokens"])
    assert not torch.equal(d1.batch(3)["tokens"], d1.batch(4)["tokens"])
    d3 = pipeline.SyntheticData(cfg, shape, seed=6, device="cpu")
    assert not torch.equal(d1.batch(3)["tokens"], d3.batch(3)["tokens"])


def test_labels_are_next_tokens():
    cfg = get_reduced_config("qwen1_5_4b")
    b = pipeline.SyntheticData(cfg, ShapeSpec("tiny", 16, 2, "train"),
                               seed=1, device="cpu").batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < cfg.vocab_size
    assert int(b["tokens"].min()) >= 0


def test_default_device_is_the_card():
    cfg = get_reduced_config("qwen1_5_4b")
    data = pipeline.SyntheticData(cfg, ShapeSpec("t", 8, 1, "train"))
    assert data.device == "cuda"
