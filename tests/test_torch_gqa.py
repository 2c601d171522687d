"""Grouped-query cross-attention of the PyTorch port against ``valor_tpu`` (fp32, CPU).

``MultiHeadAttention`` with ``kv_heads`` 1 and 2 of 2 heads, on the same
weights and numpy inputs as the JAX module, with head-broadcast bias terms,
direct and through the cached K/V: within 1e-5 (fp32 on both sides, sums in
another order).  ``kv_heads == heads`` keeps the ``state_dict`` of full
multi-head attention; an indivisible count raises JAX's error.  The tiny VALOR
with ``fusion_cross_attn_kv_heads=1``: the ``cap%tva`` loss and every gradient
within 1e-4 (the whole-model tolerance), and greedy and beam-3 captions
through the cross-K/V cache (held at one head) token for token.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import _np, seeded_models, tiny_batch, torch_config
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models import bert as tbert
from valor_tpu_torch.models.bridge import params_from_jax, train_model
from valor_tpu_torch.ops import layers as tl

TOL = 1e-4
B, Q, K, C, HEADS = 2, 5, 7, 32, 2


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_attention_matches_jax(kv_heads):
    from valor_tpu.ops import layers as jl

    rng = np.random.RandomState(kv_heads)
    q_in = rng.randn(B, Q, C).astype(np.float32)
    kv_in = rng.randn(B, K, C).astype(np.float32)
    pad = np.zeros((B, 1, 1, K), np.float32)
    pad[1, ..., -2:] = -1e4
    causal = np.where(np.arange(K)[None] <= np.arange(Q)[:, None] + 2, 0.0, -1e4)
    bias = (pad, causal[None, None].astype(np.float32))
    jm = jl.MultiHeadAttention(HEADS, kv_heads=kv_heads)
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), q_in, kv_in, bias)["params"])
    assert p["key"]["kernel"].shape == (C, C // HEADS * kv_heads)
    tm = tl.MultiHeadAttention(C, HEADS, device="cpu", kv_heads=kv_heads)
    tm.load_state_dict(params_from_jax(p), strict=True)
    t = torch.from_numpy
    with torch.no_grad():
        _close(tm(t(q_in), t(kv_in), tuple(map(t, bias))), jm.apply({"params": p}, q_in, kv_in, bias), 1e-5)
        kv = tm.compute_kv(t(kv_in))
        assert kv[0].shape == (B, kv_heads, K, C // HEADS)
        jkv = jm.apply({"params": p}, kv_in, method=jm.compute_kv)
        _close(kv[0], jkv[0], 1e-5)
        _close(tm(t(q_in), None, None, extra_kv=kv),
               jm.apply({"params": p}, q_in, None, None, extra_kv=jkv), 1e-5)


def test_grouped_attention_equals_repeated_kv():
    """Against full multi-head attention on K/V repeated to every head, with
    a bias term broadcast over the heads and one per head."""
    rng = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 3, 8, generator=rng)
    k, v = torch.randn(2, 2, 6, 8, generator=rng), torch.randn(2, 2, 6, 8, generator=rng)
    bias = (torch.randn(2, 1, 3, 6, generator=rng), torch.randn(1, 4, 3, 6, generator=rng))
    ref = tl.dot_product_attention(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1), bias)
    _close(tl.dot_product_attention(q, k, v, bias), ref, 1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        tl.dot_product_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))


def test_kv_heads_equal_to_heads_keeps_the_parameters():
    kw = dict(vocab_size=64, hidden_size=C, num_layers=1, num_heads=HEADS, intermediate=64,
              has_cross_attn=True, cross_attn_type="va_parallel")
    full = tbert.BertFusionEncoder(tbert.BertConfig(**kw), device="meta").state_dict()
    same = tbert.BertFusionEncoder(tbert.BertConfig(cross_attn_kv_heads=HEADS, **kw),
                                   device="meta").state_dict()
    narrow = tbert.BertFusionEncoder(tbert.BertConfig(cross_attn_kv_heads=1, **kw),
                                     device="meta").state_dict()
    assert {k: v.shape for k, v in same.items()} == {k: v.shape for k, v in full.items()}
    assert narrow["layer_0.cross_attn_v.attn.key.weight"].shape == (C // HEADS, C)
    assert narrow["layer_0.self_attn.attn.key.weight"].shape == (C, C)


def test_indivisible_kv_heads_raise():
    cfg = tbert.BertConfig(vocab_size=64, hidden_size=48, num_layers=1, num_heads=4, intermediate=64,
                           has_cross_attn=True, cross_attn_type="va_concate", cross_attn_kv_heads=3)
    with pytest.raises(ValueError, match="4 heads not divisible by 3 kv heads"):
        tbert.BertFusionLayer(cfg, device="meta")


@pytest.fixture(scope="module")
def gqa_models():
    return seeded_models(fusion_cross_attn_kv_heads=1, dropout=0.0, caption_type="lm")


def test_cap_loss_and_every_gradient(gqa_models):
    from valor_tpu.core.tasks import parse_task

    jm, params, _ = gqa_models
    batch = tiny_batch(seed=5)
    task = parse_task("cap%tva")

    def loss(p):
        return jm.apply({"params": p}, batch, task, True, True)["caption_loss"]

    ref, grads = jax.jit(jax.value_and_grad(loss))(params)
    tm = train_model(torch_config(jm.cfg), params_from_jax(_np(params)), "cpu")
    with tl.rng_scope(tl.RNGStreams(0)):
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse("cap%tva"))
    out["caption_loss"].backward()
    _close(out["caption_loss"].detach(), ref, TOL)
    ref_g = params_from_jax(_np(grads))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL, err_msg=name)
    assert float(tm.multimodal_encoder.layer_0.cross_attn.attn.key.weight.grad.abs().sum()) > 0


@pytest.mark.parametrize("beam_size", [1, 3])
def test_sequences_through_the_cross_kv_cache_match_jax(gqa_models, beam_size):
    from valor_tpu.eval import generate as jgen
    from valor_tpu_torch.eval import generate as tgen

    jm, params, tm = gqa_models
    batch = {k: v for k, v in tiny_batch(seed=11, b=4).items()
             if k in ("video_pixels", "audio_spectrograms")}
    with torch.no_grad():
        vin = tm.video_fusion_input(tm.encode_video(torch.from_numpy(batch["video_pixels"])))
        kv = tm.fusion_cross_kv(vin, None)
    assert kv[0]["cross_attn"][0].shape[1] == 1  # one K/V head in the cache
    ref = jgen.generate(jm, params, batch, ("tva",), max_len=6, beam_size=beam_size)
    out = tgen.generate(tm, batch, ("tva",), max_len=6, beam_size=beam_size)
    seqs = out["generated_sequences_tva"]
    assert len({tuple(r) for r in seqs.tolist()}) > 1
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref["generated_sequences_tva"]))
