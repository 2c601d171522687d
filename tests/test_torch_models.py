"""Encoders of the PyTorch port against ``valor_tpu.models`` (tiny widths, fp32, CPU, 1e-4).

CLIP vision, AST, and the BERT fusion encoder (causal, with and without the
cross-attention K/V cache, all four cross-attention topologies), plus
``encode_video`` on raw uint8 frames.  Weights go through ``params_from_jax``.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from tests.conftest import tiny_model_config
from valor_tpu.core.tasks import parse_task
from valor_tpu.models import ast as jast
from valor_tpu.models import bert as jbert
from valor_tpu.models import clip as jclip
from valor_tpu.models.valor import VALORModel as JaxVALOR
from valor_tpu_torch.core.config import ModelConfig
from valor_tpu_torch.models import ast as tast
from valor_tpu_torch.models import bert as tbert
from valor_tpu_torch.models import clip as tclip
from valor_tpu_torch.models.bridge import load_model, params_from_jax

TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, jax_params):
    module.load_state_dict(params_from_jax(_np(jax_params)), strict=True)
    return module.eval()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def torch_config(jax_cfg) -> ModelConfig:
    """The port's ModelConfig with the same fields as a valor_tpu one."""
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def tiny_batch(seed=0, b=3, n_frames=2, n_clips=1, res=32, mel=16, alen=32):
    rng = np.random.RandomState(seed)
    txt = rng.randint(106, 512, size=(b, 8)).astype(np.int32)
    txt[:, 0], txt[:, -2], txt[:, -1] = 101, 102, 0
    return {
        "bert_tokens": txt,
        "clip_tokens": txt,
        "video_pixels": rng.randn(b, n_frames, res, res, 3).astype(np.float32),
        "audio_spectrograms": rng.randn(b, n_clips, mel, alen).astype(np.float32),
    }


@torch.no_grad()
def test_clip_vision():
    cfg = jclip.vision_preset("clip_vit_tiny")
    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    jm = jclip.CLIPVisionTransformer(cfg)
    p = jm.init(jax.random.PRNGKey(0), x)["params"]
    tm = _load(tclip.CLIPVisionTransformer(tclip.vision_preset("clip_vit_tiny"), device="cpu"), p)
    out = tm(torch.from_numpy(x))
    assert out.shape == (3, 5, 32)
    _close(out, jm.apply({"params": p}, x))


@torch.no_grad()
def test_ast():
    kw = dict(hidden_size=32, layers=2, heads=2, intermediate=64, melbins=32, target_length=48)
    x = np.random.RandomState(1).randn(2, 32, 48).astype(np.float32)
    jm = jast.ASTEncoder(jast.ASTConfig(dropout=0.0, **kw))
    p = jm.init(jax.random.PRNGKey(1), x)["params"]
    tm = _load(tast.ASTEncoder(tast.ASTConfig(**kw), device="cpu"), p)
    out = tm(torch.from_numpy(x))
    assert out.shape == (2, 1 + 2 * 3, 32)  # (freq, time) patches + CLS
    _close(out, jm.apply({"params": p}, x))


def _bert_cfgs(cross_type):
    kw = dict(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2, intermediate=64,
              has_cross_attn=cross_type is not None, cross_attn_type=cross_type)
    return jbert.BertConfig(dropout=0.0, **kw), tbert.BertConfig(**kw)


@pytest.mark.parametrize("cross_type", ["va_concate", "va_parallel", "video_audio", "audio_video"])
@pytest.mark.parametrize("use_cache", [False, True])
@torch.no_grad()
def test_bert_fusion_encoder_cross_attention(cross_type, use_cache):
    rng = np.random.RandomState(2)
    tokens = rng.randint(106, 512, size=(2, 7)).astype(np.int32)
    tokens[:, 0] = 101
    token_mask = (np.arange(7)[None] <= np.array([[3], [6]])).astype(np.float32)
    video = rng.randn(2, 10, 32).astype(np.float32)
    audio = rng.randn(2, 4, 32).astype(np.float32)
    jcfg, tcfg = _bert_cfgs(cross_type)
    jm = jbert.BertFusionEncoder(jcfg)
    p = jm.init(jax.random.PRNGKey(2), tokens, None, video, audio, True)["params"]
    tm = _load(tbert.BertFusionEncoder(tcfg, device="cpu"), p)
    t = torch.from_numpy
    if use_cache:
        jkv = jm.apply({"params": p}, video, audio, method=jm.precompute_cross_kv)
        ref = jm.apply({"params": p}, tokens, None, None, None, True, False, token_mask, jkv)
        tkv = tm.precompute_cross_kv(t(video), t(audio))
        out = tm(t(tokens), None, None, None, True, False, t(token_mask), tkv)
    else:
        ref = jm.apply({"params": p}, tokens, None, video, audio, True, False, token_mask)
        out = tm(t(tokens), None, t(video), t(audio), True, False, t(token_mask))
    _close(out, ref)


@pytest.mark.parametrize("causal,full_masker", [(False, False), (True, False), (True, True)])
@torch.no_grad()
def test_bert_fusion_encoder_in_sequence_media(causal, full_masker):
    """Without cross-attention the media and a prompt join the sequence."""
    rng = np.random.RandomState(3)
    tokens = rng.randint(106, 512, size=(2, 6)).astype(np.int32)
    prompt = rng.randint(106, 512, size=(2, 3)).astype(np.int32)
    prompt[1, -1] = 0
    video = rng.randn(2, 5, 32).astype(np.float32)
    jcfg, tcfg = _bert_cfgs(None)
    jm = jbert.BertFusionEncoder(jcfg)
    p = jm.init(jax.random.PRNGKey(3), tokens, prompt, video, None, causal, full_masker)["params"]
    tm = _load(tbert.BertFusionEncoder(tcfg, device="cpu"), p)
    ref = jm.apply({"params": p}, tokens, prompt, video, None, causal, full_masker)
    out = tm(torch.from_numpy(tokens), torch.from_numpy(prompt), torch.from_numpy(video),
             None, causal, full_masker)
    _close(out, ref)


@torch.no_grad()
def test_prediction_head():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 32).astype(np.float32)
    table = rng.randn(512, 32).astype(np.float32) * 0.1
    jm = jbert.BertPredictionHead()
    p = jm.init(jax.random.PRNGKey(4), x, table)["params"]
    p = dict(p, decoder_bias=rng.randn(512).astype(np.float32))
    tm = _load(tbert.BertPredictionHead(32, 512, device="cpu"), p)
    _close(tm(torch.from_numpy(x), torch.from_numpy(table)), jm.apply({"params": p}, x, table))


PT_TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"


def tiny_models(task=PT_TASK, kernel_scale=1.0, **cfg_kw):
    """(jax model, jax params, torch model) holding the same weights.

    flax creates the parameters of the modules that the init call runs, so
    ``task`` has to reach every head the port builds: the pretraining task does.

    ``kernel_scale`` multiplies every matmul and conv kernel of the JAX init:
    at 8 the attention is sharp enough that each row's caption depends on
    its media, which the default init (N(0, 0.02)) does not give."""
    cfg = tiny_model_config(**cfg_kw)
    jm = JaxVALOR(cfg)
    params = jm.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        tiny_batch(), parse_task(task), True, True,
    )["params"]
    if kernel_scale != 1.0:
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: x * kernel_scale if path[-1].key == "kernel" else x, params)
    tm = load_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")
    return jm, params, tm


def jax_layout(sd, shapes):
    """The port's ``state_dict`` ``sd`` as a JAX parameter tree of the structure
    of ``shapes`` (the inverse of ``params_from_jax``, which must name a port
    parameter for every JAX leaf)."""
    def leaf(path, shape):
        *mods, name = [k.key for k in path]
        key = ".".join(mods + ["weight" if name in ("kernel", "scale", "embedding") else name])
        t = sd[key].detach().cpu().numpy()
        if name == "kernel":
            t = np.ascontiguousarray(t.transpose(tuple(range(2, t.ndim)) + (1, 0)))
        assert t.shape == tuple(shape.shape), key
        return t

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_shapes(jm, task=PT_TASK, **batch_kw):
    """The structure and shapes of a JAX model's parameter tree: ``jax.eval_shape``
    of its init on ``tiny_batch(**batch_kw)``, which traces and computes nothing."""
    spec = parse_task(task)
    return jax.eval_shape(lambda r, b: jm.init(r, b, spec, True, True),
                          {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                          tiny_batch(**batch_kw))["params"]


def seeded_models(task=PT_TASK, seed=0, res=32, **cfg_kw):
    """(jax model, jax params, torch model) holding the port's seeded weights
    (``init_params``, N(0, 1/fan_in) kernels: attention sharp enough that
    captions follow their media).  The JAX tree's structure comes from
    ``jax.eval_shape`` of its init, which traces and computes nothing, and
    ``jax_layout`` fills it: every JAX parameter must have its port
    counterpart and the two key sets must be equal.  ``res``: the frames'
    size of the init batch."""
    from valor_tpu_torch.models.bridge import init_params

    cfg = tiny_model_config(**cfg_kw)
    jm = JaxVALOR(cfg)
    sd = init_params(torch_config(cfg), seed, "cpu")
    params = jax_layout(sd, jax_shapes(jm, task, res=res))
    assert set(params_from_jax(_np(params))) == set(sd)
    return jm, params, load_model(torch_config(cfg), sd, "cpu")


@pytest.mark.parametrize("fusion_hidden", [32, 48])  # 48: through the adapters
@torch.no_grad()
def test_encode_video_uint8_and_fusion_inputs(fusion_hidden):
    jm, params, tm = tiny_models(fusion_hidden=fusion_hidden)
    rng = np.random.RandomState(5)
    pixels = rng.randint(0, 256, size=(2, 3, 32, 32, 3), dtype=np.uint8)
    spec = rng.randn(2, 2, 16, 32).astype(np.float32)
    ref_v = jm.apply({"params": params}, pixels, method=jm.encode_video)
    out_v = tm.encode_video(torch.from_numpy(pixels))
    _close(out_v, ref_v)
    _close(tm.video_fusion_input(out_v),
           jm.apply({"params": params}, ref_v, method=jm.video_fusion_input))
    ref_a = jm.apply({"params": params}, spec, method=jm.encode_audio)
    out_a = tm.encode_audio(torch.from_numpy(spec))
    _close(out_a, ref_a)
    _close(tm.audio_fusion_input(out_a),
           jm.apply({"params": params}, ref_a, method=jm.audio_fusion_input))


@pytest.mark.parametrize("name", ["caption-valor32k.json", "pretrain-valor-base.json", "qa-msrvtt.json"])
def test_config_and_task_copies_match_jax(name):
    from valor_tpu.core.config import load_config as jax_load
    from valor_tpu.core.tasks import parse_task as jax_parse
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task

    path = str(pathlib.Path(__file__).resolve().parents[1] / "configs" / name)
    over = {"fp16": "true", "test_batch_size": 8}
    assert dataclasses.asdict(load_config(path, over)) == dataclasses.asdict(jax_load(path, over))
    for task in ("cap%tva", "ret%tva%tv", "qa%tv", "pt_contra%tva%tv_caption%tva_mlm%ta"):
        assert dataclasses.asdict(parse_task(task)) == dataclasses.asdict(jax_parse(task))
