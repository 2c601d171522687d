"""Caption generation of the PyTorch port against ``valor_tpu.eval.generate``.

The tiny VALOR model in fp32 on the CPU, the same weights in both packages:
greedy and beam-3 sequences of ``cap%tva`` and ``cap%tv`` must be equal token
for token, and one decode step's logits within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import tiny_batch, tiny_models
from valor_tpu.eval import generate as jgen
from valor_tpu_torch.eval import generate as tgen
from valor_tpu_torch.models.valor import EOS_TOKEN

TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return tiny_models(kernel_scale=8.0)


def _media(batch):
    return {k: batch[k] for k in ("video_pixels", "audio_spectrograms")}


@pytest.mark.parametrize("group", ["tva", "tv"])
@pytest.mark.parametrize("beam_size", [1, 3])
def test_sequences_match_jax(models, group, beam_size):
    jm, params, tm = models
    batch = _media(tiny_batch(seed=11, b=4))
    ref = jgen.generate(jm, params, batch, (group,), max_len=6, beam_size=beam_size)
    out = tgen.generate(tm, batch, (group,), max_len=6, beam_size=beam_size)
    seqs = out[f"generated_sequences_{group}"]
    assert seqs.dtype == torch.int32 and seqs.shape == (4, 6)
    assert len({tuple(r) for r in seqs.tolist()}) > 1  # captions follow the media
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref[f"generated_sequences_{group}"]))


def test_lm_caption_type_matches_jax(models):
    jm, params, tm = models
    batch = _media(tiny_batch(seed=12, b=2))
    ref = jgen.generate(jm, params, batch, ("tv",), caption_type="lm", max_len=5)
    out = tgen.generate(tm, batch, ("tv",), caption_type="lm", max_len=5)
    np.testing.assert_array_equal(out["generated_sequences_tv"].numpy(),
                                  np.asarray(ref["generated_sequences_tv"]))


@pytest.mark.parametrize("group", ["tva", "tv"])
@torch.inference_mode()
def test_decoder_logits_match_jax(models, group):
    jm, params, tm = models
    batch = _media(tiny_batch(seed=13, b=3))
    p = {"params": params}
    jv = jm.apply(p, jm.apply(p, batch["video_pixels"], method=jm.encode_video),
                  method=jm.video_fusion_input)
    tv = tm.video_fusion_input(tm.encode_video(torch.from_numpy(batch["video_pixels"])))
    ja = ta = None
    if "a" in group:
        ja = jm.apply(p, jm.apply(p, batch["audio_spectrograms"], method=jm.encode_audio),
                      method=jm.audio_fusion_input)
        ta = tm.audio_fusion_input(tm.encode_audio(torch.from_numpy(batch["audio_spectrograms"])))
    jdec = jgen.make_fusion_decoder(jm, params, None, jv, ja)
    tdec = tgen.make_fusion_decoder(tm, None, tv, ta)
    rng = np.random.RandomState(14)
    buffer = rng.randint(106, 512, size=(3, 8)).astype(np.int32)
    buffer[:, 0] = 101
    for t in (0, 3):
        tokens, mask, _ = jgen._prepare_step(jnp.asarray(buffer), t, "unimlm")
        ref = jdec(tokens, mask)
        out = tdec(torch.tensor(np.asarray(tokens)).long(), torch.tensor(np.asarray(mask)))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_sampling_latch_and_generator(models):
    _, _, tm = models
    batch = _media(tiny_batch(seed=15, b=4))
    runs = [
        tgen.generate(tm, batch, ("tv",), max_len=6, mode="sample",
                      generator=torch.Generator().manual_seed(7))
        for _ in range(2)
    ]
    seqs, logps = runs[0]["generated_sequences_tv"].numpy(), runs[0]["logprobs_tv"].numpy()
    np.testing.assert_array_equal(seqs, runs[1]["generated_sequences_tv"].numpy())
    assert seqs.shape == (4, 6) and logps.shape == (4, 6)
    assert (logps <= 0).all() and ((seqs >= 0) & (seqs < 512)).all()
    for row in seqs:  # after EOS, only EOS
        hit = np.flatnonzero(row == EOS_TOKEN)
        if hit.size:
            assert (row[hit[0]:] == EOS_TOKEN).all()


def test_generator_stats_count_batches(models):
    _, _, tm = models
    batch = _media(tiny_batch(seed=16, b=2))
    g = tgen.Generator(tm)
    for _ in range(2):
        g.generate(batch, ("tv",), max_len=3)
    g.generate(batch, ("tv",), max_len=3, beam_size=2)
    assert g.stats() == {
        ("decode", "unimlm", 3, 1, "greedy"): 2,
        ("decode", "unimlm", 3, 2, "greedy"): 1,
    }


@pytest.mark.parametrize("beam_size", [1, 3])
def test_sequences_from_waveforms_match_jax(models, beam_size):
    """Clip-span waveforms (the device fbank's input, one clip without audio)
    decode to the JAX package's sequences, token for token, and to the port's
    own sequences from the same clips' log-mel spectrograms."""
    from valor_tpu_torch.data.fbank import clip_span_samples, fbank_clips_from_spans

    jm, params, tm = models
    rng = np.random.RandomState(17)
    batch = {"video_pixels": tiny_batch(seed=17, b=4)["video_pixels"],
             "audio_waveforms": (rng.randn(4, 2, clip_span_samples(32)) * 0.3).astype(np.float32),
             "audio_valid_frames": np.array([[32, 5], [32, 32], [-1, -1], [20, 32]], np.int32)}
    ref = jgen.generate(jm, params, batch, ("tva", "ta"), max_len=6, beam_size=beam_size)
    out = tgen.generate(tm, batch, ("tva", "ta"), max_len=6, beam_size=beam_size)
    spec = fbank_clips_from_spans(torch.from_numpy(batch["audio_waveforms"]),
                                  torch.from_numpy(batch["audio_valid_frames"]), melbins=16, target_length=32)
    from_spec = tgen.generate(tm, {"video_pixels": batch["video_pixels"], "audio_spectrograms": spec},
                              ("tva", "ta"), max_len=6, beam_size=beam_size)
    for g in ("tva", "ta"):
        seqs = out[f"generated_sequences_{g}"].numpy()
        np.testing.assert_array_equal(seqs, np.asarray(ref[f"generated_sequences_{g}"]))
        np.testing.assert_array_equal(seqs, from_spec[f"generated_sequences_{g}"].numpy())
    assert len({tuple(r) for r in out["generated_sequences_ta"].tolist()}) > 1  # captions follow the audio


# -- the context-K/V decode (multimodal_use_cross_attn=False) ------------------

@pytest.fixture(scope="module")
def ctx_models():
    return tiny_models(kernel_scale=8.0, multimodal_use_cross_attn=False)


PROMPT = np.asarray([[101, 110, 120, 130, 102]], np.int32)


@pytest.mark.parametrize("group", ["tva", "tv"])
@pytest.mark.parametrize("prompt", [False, True])
@torch.inference_mode()
def test_decode_with_ctx_logits_match_full_forward_and_jax(ctx_models, group, prompt):
    """The cached [prompt | media] context: the decode's logits within 1e-4 of
    the port's full forward with the media in the sequence, and of JAX's
    ``fusion_logits_ctx``, at two steps of the buffer."""
    jm, params, tm = ctx_models
    batch = _media(tiny_batch(seed=15, b=3))
    p = {"params": params}
    jv = jm.apply(p, jm.apply(p, batch["video_pixels"], method=jm.encode_video),
                  method=jm.video_fusion_input)
    tv = tm.video_fusion_input(tm.encode_video(torch.from_numpy(batch["video_pixels"])))
    ja = ta = None
    if "a" in group:
        ja = jm.apply(p, jm.apply(p, batch["audio_spectrograms"], method=jm.encode_audio),
                      method=jm.audio_fusion_input)
        ta = tm.audio_fusion_input(tm.encode_audio(torch.from_numpy(batch["audio_spectrograms"])))
    jp = np.repeat(PROMPT, 3, axis=0) if prompt else None
    tp = torch.from_numpy(jp).long() if prompt else None
    jkv, jmask = jm.apply(p, jp, jv, ja, method=jm.fusion_ctx_kv)
    tkv, tmask = tm.fusion_ctx_kv(tp, tv, ta)
    assert len(tkv) == 2 and tkv[0][0].shape == (3, 2, tmask.shape[1], 16)
    rng = np.random.RandomState(16)
    buffer = rng.randint(106, 512, size=(3, 8)).astype(np.int32)
    buffer[:, 0] = 101
    for t in (0, 4):
        tokens, mask, _ = jgen._prepare_step(jnp.asarray(buffer), t, "unimlm")
        tt, tm_mask = torch.tensor(np.asarray(tokens)).long(), torch.tensor(np.asarray(mask))
        out = tm.fusion_logits_ctx(tt, tm_mask, tkv, tmask)
        full = tm.fusion_logits(tt, tp, tv, ta, True, False, tm_mask)
        ref = jm.apply(p, tokens, mask, jkv, jmask, method=jm.fusion_logits_ctx)
        np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("group", ["tva", "ta"])
def test_ctx_sequences_match_jax(ctx_models, beam_size, group):
    """Greedy and beam-3 captions through the context-K/V decode, with the
    caption prompt, equal to JAX's token for token."""
    jm, params, tm = ctx_models
    batch = dict(_media(tiny_batch(seed=17, b=4)), prompt_tokens_caption=PROMPT)
    ref = jgen.generate(jm, params, batch, (group,), max_len=6, beam_size=beam_size)
    out = tgen.generate(tm, batch, (group,), max_len=6, beam_size=beam_size)
    seqs = out[f"generated_sequences_{group}"]
    assert seqs.shape == (4, 6)
    assert len({tuple(r) for r in seqs.tolist()}) > 1  # captions follow the media
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref[f"generated_sequences_{group}"]))
