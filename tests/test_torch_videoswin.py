"""VideoSwin video tower of the PyTorch port against ``valor_tpu.models.videoswin`` (fp32, CPU).

The tower on the same weights and numpy video as the JAX module, at the tiny
preset and at a config whose volume needs padding and whose odd blocks shift
their windows: features within 1e-4 (the whole-model tolerance), and the
shift mask and relative index equal exactly (both numpy).  The tiny VALOR
with ``videoswin_tiny_test`` and BERT text: ``pt_contra%tv_caption%tv``
losses and every gradient within 1e-4.  With CLIP text beside it: the same
parameter keys as JAX, contrastive heads of its own (F7), features and the
temperature within 1e-4.  uint8 pixels normalised with ImageNet's statistics
(F8) within 1e-5 of JAX.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import _np, seeded_models, tiny_batch, torch_config
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from valor_tpu_torch.models import videoswin as tvs
from valor_tpu_torch.models.bridge import params_from_jax, train_model
from valor_tpu_torch.ops.layers import RNGStreams, rng_scope

TOL = 1e-4
SWIN_BERT = dict(video_encoder_type="videoswin_tiny_test", txt_encoder_type="bert_base_uncased",
                 init_clip_head=False)
SHIFTED = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 2), window_size=(2, 3, 3))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["tiny_preset", "shifted_and_padded"])
def test_tower_matches_jax(case):
    from valor_tpu.models import videoswin as jvs

    if case == "tiny_preset":
        jcfg, tcfg, shape = jvs.swin_preset("videoswin_tiny_test"), tvs.swin_preset("videoswin_tiny_test"), (2, 2, 32, 32)
    else:  # 3 frames of 36 px: D' 3 and a 9 x 9 grid, padded to the (2, 3, 3) window
        jcfg, tcfg, shape = jvs.SwinConfig(**SHIFTED), tvs.SwinConfig(**SHIFTED), (2, 3, 36, 36)
    video = np.random.RandomState(0).randn(*shape, 3).astype(np.float32)
    jm = jvs.SwinTransformer3D(jcfg)
    p = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), video)["params"])
    p = jax.tree_util.tree_map_with_path(  # tables of N(0, 1): the bias must matter
        lambda path, x: x * 50.0 if path[-1].key == "relative_position_bias_table" else x, p)
    tm = tvs.SwinTransformer3D(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(p), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(video))
    ref = jax.jit(jm.apply)({"params": p}, video)
    assert out.shape == ref.shape
    _close(out, ref)


@pytest.mark.parametrize("dims,window,shift", [
    ((4, 6, 6), (2, 3, 3), (1, 1, 1)), ((2, 8, 8), (2, 2, 2), (0, 1, 1)), ((8, 14, 14), (8, 7, 7), (4, 3, 3)),
])
def test_shift_mask_and_relative_index_equal_jax(dims, window, shift):
    from valor_tpu.models import videoswin as jvs

    np.testing.assert_array_equal(tvs.np_shift_mask(dims, window, shift),
                                  jvs._np_shift_mask(dims, window, shift))
    np.testing.assert_array_equal(tvs.np_relative_index(window), jvs._np_relative_index(window))
    assert tvs.effective_window(dims, window, shift) == jvs.effective_window(dims, window, shift)


@pytest.fixture(scope="module")
def swin_models():
    return seeded_models(dropout=0.0, caption_type="lm", **SWIN_BERT)


def test_pt_losses_and_every_gradient(swin_models):
    from valor_tpu.core.tasks import parse_task

    jm, params, _ = swin_models
    assert "video_encoder" in params and "clip_vision" not in params
    batch = tiny_batch(seed=6)
    task = parse_task("pt_contra%tv_caption%tv")

    def loss(p):
        out = jm.apply({"params": p}, batch, task, True, True)
        return sum(out.values()), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = train_model(torch_config(jm.cfg), params_from_jax(_np(params)), "cpu")
    with rng_scope(RNGStreams(0)):
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse("pt_contra%tv_caption%tv"))
    sum(out.values()).backward()
    assert set(out) == set(ref) == {"contra_loss", "caption_loss"}
    for k in ref:
        _close(out[k].detach(), ref[k])
    ref_g = params_from_jax(_np(grads))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL, err_msg=name)
    assert float(tm.video_encoder.patch_embed.weight.grad.abs().sum()) > 0


@torch.no_grad()
def test_clip_text_beside_videoswin_keeps_its_own_heads():
    """F7: with a VideoSwin video tower the contrastive heads are
    ``contra_head_t``/``contra_head_v`` at ``contra_dim`` even with CLIP text,
    and the temperature is ``contra_temp``; no CLIP vision tower and no CLIP
    projections, as JAX creates no parameters for them (``seeded_models``
    checks the keys)."""
    jm, params, tm = seeded_models(video_encoder_type="videoswin_tiny_test", txt_encoder_type="clip_vit_tiny")
    assert not tm.use_clip_head and "contra_head_v" in params and "clip_text" in params
    assert "clip_vision" not in params and "clip_proj" not in params
    assert tm.contra_head_v.weight.shape == (jm.cfg.contra_dim, tm.video_dim)
    batch = tiny_batch(seed=7)

    def features(p, pixels, tokens):
        v = jm.apply(p, pixels, method=jm.encode_video)
        return v, jm.apply(p, tokens, v, None, method=jm.contra_features), jm.apply(p, method=jm.temperature)

    ref_v, ref, ref_temp = jax.jit(features)({"params": params}, batch["video_pixels"], batch["clip_tokens"])
    out_v = tm.encode_video(torch.from_numpy(batch["video_pixels"]))
    out = tm.contra_features(torch.from_numpy(batch["clip_tokens"]), out_v, None)
    _close(out_v, ref_v)
    for k in ("feat_t", "feat_v"):
        _close(out[k], ref[k])
    _close(tm.temperature(), ref_temp)


@torch.no_grad()
def test_uint8_pixels_use_imagenet_statistics(swin_models):
    """F8: a non-CLIP video tower normalises raw pixels with ImageNet's mean and std."""
    jm, params, tm = swin_models
    np.testing.assert_array_equal(tm.pixel_stats.numpy(), np.stack([IMAGENET_MEAN, IMAGENET_STD]))
    pixels = np.random.RandomState(8).randint(0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)

    def encode(p, px):
        v = jm.apply(p, px, method=jm.encode_video)
        return v, jm.apply(p, v, method=jm.pool_video), jm.apply(p, v, method=jm.video_fusion_input)

    ref, ref_pool, ref_fused = jax.jit(encode)({"params": params}, pixels)
    out = tm.encode_video(torch.from_numpy(pixels))
    assert out.shape == ref.shape == (2, 2, 16, 16)  # [B, D', H'W', C]
    _close(out, ref, 1e-5)
    _close(tm.pool_video(out), ref_pool, 1e-5)
    _close(tm.video_fusion_input(out), ref_fused, 1e-5)
    assert dataclasses.asdict(tm.video_encoder.cfg) == dataclasses.asdict(tvs.swin_preset("videoswin_tiny_test"))
