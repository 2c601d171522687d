"""The port's weight converters (``valor_tpu_torch/models/convert.py``) and the
paths that read public and released weights (``cli/build.py:
initialize_encoder_weights``, ``cli.train --checkpoint <file>``) against
``valor_tpu`` (CPU, tiny widths, fp32).

Inputs are tests/test_convert.py's synthetic state dicts (BERT, CLIP, a whole
VALOR checkpoint) and an AudioSet AST and a VideoSwin state dict built here.
Tolerances: converted trees exactly, the position-embedding resizes (the port's
numpy resize against ``jax.image.resize``) within 1e-6; losses of a model
loaded through each package's converter within 1e-4 (the whole-model
tolerance), with ``caption_type="lm"`` so that no masking draw enters.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.conftest import tiny_model_config
from tests.test_convert import _rand, synth_bert_sd, synth_clip_sd, synth_valor_full_sd
from tests.test_torch_models import _np, tiny_batch, torch_config
from valor_tpu.core.tasks import parse_task
from valor_tpu.models import convert as JC
from valor_tpu.models.valor import VALORModel as JaxVALOR
from valor_tpu.train.checkpoints import adapt_pretrained_params as jadapt
from valor_tpu_torch.cli.build import converted_state_dict
from valor_tpu_torch.data.synthetic import released_state_dicts, save_jit_archive
from valor_tpu_torch.models import convert as TC
from valor_tpu_torch.models.bridge import load_model, params_from_jax
from valor_tpu_torch.train.checkpoints import adapt_pretrained_params as tadapt

TOL = 1e-4
TASK = "pt_contra%tva_caption%tva"


def synth_ast_sd(hidden=32, layers=2, inter=64):
    """AudioSet AST names (``module.v.*``; a 12 x 101 grid and two leading tokens)."""
    sd = {
        "module.v.cls_token": _rand(1, 1, hidden),
        "module.v.dist_token": _rand(1, 1, hidden),
        "module.v.pos_embed": _rand(1, 2 + 12 * 101, hidden),
        "module.v.patch_embed.proj.weight": _rand(hidden, 1, 16, 16),
        "module.v.patch_embed.proj.bias": _rand(hidden),
        "module.v.norm.weight": _rand(hidden),
        "module.v.norm.bias": _rand(hidden),
    }
    for i in range(layers):
        p = f"module.v.blocks.{i}"
        sd.update({f"{p}.norm1.weight": _rand(hidden), f"{p}.norm1.bias": _rand(hidden),
                   f"{p}.norm2.weight": _rand(hidden), f"{p}.norm2.bias": _rand(hidden),
                   f"{p}.attn.qkv.weight": _rand(3 * hidden, hidden), f"{p}.attn.qkv.bias": _rand(3 * hidden),
                   f"{p}.attn.proj.weight": _rand(hidden, hidden), f"{p}.attn.proj.bias": _rand(hidden),
                   f"{p}.mlp.fc1.weight": _rand(inter, hidden), f"{p}.mlp.fc1.bias": _rand(inter),
                   f"{p}.mlp.fc2.weight": _rand(hidden, inter), f"{p}.mlp.fc2.bias": _rand(hidden)})
    return sd


def synth_videoswin_sd(c=8, heads=2):
    """VideoSwin names (``backbone.*``): two stages of two blocks, one patch merge."""
    sd = {
        "backbone.patch_embed.proj.weight": _rand(c, 3, 2, 4, 4),
        "backbone.patch_embed.proj.bias": _rand(c),
        "backbone.patch_embed.norm.weight": _rand(c),
        "backbone.patch_embed.norm.bias": _rand(c),
        "backbone.norm.weight": _rand(2 * c),
        "backbone.norm.bias": _rand(2 * c),
        "backbone.layers.0.downsample.reduction.weight": _rand(2 * c, 4 * c),
        "backbone.layers.0.downsample.norm.weight": _rand(4 * c),
        "backbone.layers.0.downsample.norm.bias": _rand(4 * c),
    }
    for s, w in ((0, c), (1, 2 * c)):
        for b in range(2):
            p = f"backbone.layers.{s}.blocks.{b}"
            sd.update({f"{p}.norm1.weight": _rand(w), f"{p}.norm1.bias": _rand(w),
                       f"{p}.norm2.weight": _rand(w), f"{p}.norm2.bias": _rand(w),
                       f"{p}.attn.qkv.weight": _rand(3 * w, w),
                       f"{p}.attn.proj.weight": _rand(w, w), f"{p}.attn.proj.bias": _rand(w),
                       f"{p}.attn.relative_position_bias_table": _rand(3 * 13 * 13, heads),
                       f"{p}.mlp.fc1.weight": _rand(4 * w, w), f"{p}.mlp.fc1.bias": _rand(4 * w),
                       f"{p}.mlp.fc2.weight": _rand(w, 4 * w), f"{p}.mlp.fc2.bias": _rand(w)})
            if b == 0:
                sd[f"{p}.attn.qkv.bias"] = _rand(3 * w)
    return sd


def _assert_trees_equal(got, want, path="", atol=0.0):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), f"{path}: {sorted(set(got) ^ set(want))}"
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}", atol)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        if atol and "pos" in path:  # the resized position embeddings
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


CASES = {
    "bert": lambda M: M.convert_bert(synth_bert_sd()),
    "bert_txt_encoder": lambda M: M.convert_bert({f"bert.{k}".replace("LayerNorm.weight", "LayerNorm.gamma"): v
                                                  for k, v in synth_bert_sd().items()}, target="txt_encoder"),
    "clip": lambda M: M.convert_clip(synth_clip_sd()),
    "clip_resized": lambda M: M.convert_clip(synth_clip_sd(), resolution=64),
    "ast": lambda M: M.convert_ast(synth_ast_sd(), melbins=16, target_length=32),
    "ast_base_grid": lambda M: M.convert_ast(synth_ast_sd(), melbins=64, target_length=512),
    "ast_inmodel": lambda M: M._convert_ast_inmodel(synth_valor_full_sd()),
    "fine_weight": lambda M: M._fine_weight(synth_valor_full_sd(), "text_fine_weight"),
    "videoswin": lambda M: M.convert_videoswin(synth_videoswin_sd()),
    "valor_full": lambda M: M.convert_valor_full(synth_valor_full_sd(), resolution=32),
    "valor_full_resized": lambda M: M.convert_valor_full(synth_valor_full_sd(), resolution=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_tree_equals_jax(case):
    _assert_trees_equal(CASES[case](TC), CASES[case](JC), case, atol=1e-6)


def test_layout_helpers_equal_jax():
    sd = synth_clip_sd()
    p = "visual.transformer.resblocks.0"
    for fn, key in (("_lin", f"{p}.mlp.c_fc"), ("_lin_nob", f"{p}.mlp.c_fc"), ("_ln", f"{p}.ln_1"),
                    ("_attn_from_inproj", f"{p}.attn")):
        _assert_trees_equal(getattr(TC, fn)(sd, key), getattr(JC, fn)(sd, key), fn)


def _write(kind, sd, path):
    if kind == "clip_jit":
        save_jit_archive({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    elif kind == "ast":
        torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}}, path)
    else:
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)


LAYOUTS = {
    "valor": (synth_valor_full_sd, "clip_vision"),
    "clip": (synth_clip_sd, "clip_vision"),
    "clip_jit": (synth_clip_sd, "clip_vision"),
    "ast": (synth_ast_sd, "audio_encoder"),
    "videoswin": (synth_videoswin_sd, "video_encoder"),
    "bert": (synth_bert_sd, "multimodal_encoder"),
}


@pytest.mark.parametrize("kind", sorted(LAYOUTS))
def test_load_converted_detects_the_layout(kind, tmp_path):
    make, top = LAYOUTS[kind]
    path = str(tmp_path / f"{kind}.pt")
    _write(kind, make(), path)
    got = TC.load_converted(path, resolution=32)
    assert top in got
    _assert_trees_equal(got, JC.load_converted(path, resolution=32), kind, atol=1e-6)


def test_the_jax_test_s_jit_archive_loads_alike(tmp_path):
    """tests/test_convert.py's way of writing a JIT archive, read by both."""
    from torch import nn

    class Holder(nn.Module):
        def forward(self):
            return torch.zeros(1)

    root = Holder()
    for key, val in synth_clip_sd().items():
        *parts, leaf = key.split(".")
        m = root
        for p in parts:
            if not hasattr(m, p):
                setattr(m, p, nn.Module())
            m = getattr(m, p)
        m.register_parameter(leaf, nn.Parameter(torch.from_numpy(np.asarray(val))))
    path = str(tmp_path / "clip_jit.pt")
    torch.jit.save(torch.jit.script(root), path)
    _assert_trees_equal(TC.load_converted(path), JC.load_converted(path), "jit", atol=1e-6)


def test_unrecognised_layout_raises(tmp_path):
    path = str(tmp_path / "odd.pt")
    torch.save({"something.else": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="unrecognised checkpoint layout"):
        TC.load_converted(path)


def test_released_layout_writers_convert_alike():
    """The port's full-width writers (``data/synthetic.py``), at the tiny
    config: both packages convert them to one tree, and the whole VALOR
    checkpoint covers every parameter of the tiny model."""
    cfg = torch_config(tiny_model_config())
    sds = {k: {n: t.numpy() for n, t in v.items()} for k, v in released_state_dicts(cfg).items()}
    trees = {
        "clip": lambda M: M.convert_clip(sds["clip"], resolution=32),
        "bert": lambda M: M.convert_bert(sds["bert"]),
        "ast": lambda M: M.convert_ast(sds["ast"], melbins=16, target_length=32),
        "valor": lambda M: M.convert_valor_full(sds["valor"], resolution=32),
    }
    for name, fn in trees.items():
        _assert_trees_equal(fn(TC), fn(JC), name, atol=1e-6)
    from valor_tpu_torch.models.valor import VALORModel

    target = VALORModel(cfg, device="meta").state_dict()
    full = converted_state_dict(trees["valor"](TC))
    assert set(full) == set(target)
    assert all(tuple(full[k].shape) == tuple(target[k].shape) for k in target)


def test_videoswin_weights_convert_into_the_model(tmp_path, monkeypatch):
    """A VideoSwin file in the released layout (``backbone.*``: two stages of
    two blocks, window (2, 7, 7), the second block without a qkv bias) under
    ``$VALOR_PRETRAINED_DIR``, found by the tower's name and converted and
    adapted into the tiny model by each package
    (``cli/build.py:initialize_encoder_weights``, through
    ``converted_state_dict``): the same weights tensor for tensor, every file
    tensor in the port's tower, and the same video features within 1e-4."""
    from tests.test_torch_models import jax_layout, jax_shapes
    from valor_tpu.cli.build import initialize_encoder_weights as jinit
    from valor_tpu.models import videoswin as jvs
    from valor_tpu_torch.cli import build as TB
    from valor_tpu_torch.cli.build import initialize_encoder_weights as tinit
    from valor_tpu_torch.models import videoswin as tvs
    from valor_tpu_torch.models.bridge import init_params

    name = "videoswin_base_k600_22k"  # the file name's key; the widths stay tiny
    swin = dict(embed_dim=8, depths=(2, 2), num_heads=(2, 2), window_size=(2, 7, 7))
    monkeypatch.setitem(jvs._PRESETS, name, jvs.SwinConfig(**swin))
    monkeypatch.setitem(tvs._PRESETS, name, tvs.SwinConfig(**swin))
    d = tmp_path / "pretrained"
    d.mkdir()
    file_sd = synth_videoswin_sd()
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in file_sd.items()}},
               str(d / TB._SWIN_WEIGHTS[name]))
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(d))
    cfg = tiny_model_config(video_encoder_type=name, txt_encoder_type="bert_base_uncased",
                            init_clip_head=False, initial_multimodal=False)
    tcfg = torch_config(cfg)
    jm = JaxVALOR(cfg)
    start = init_params(tcfg, 0, "cpu")
    got = tinit(tcfg, dict(start))
    jparams = jinit(cfg, jax_layout(start, jax_shapes(jm, TASK)))
    want = params_from_jax(_np(jparams))
    assert got.keys() == want.keys() == start.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    from_file = converted_state_dict(TC.convert_videoswin(file_sd))
    assert len(from_file) == len(file_sd) and all(k.startswith("video_encoder.") for k in from_file)
    for k, v in from_file.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert got["video_encoder.patch_embed.weight"].shape == (8, 3, 2, 4, 4)
    video = tiny_batch(seed=4)["video_pixels"]
    with torch.no_grad():
        out = load_model(tcfg, got, "cpu").encode_video(torch.from_numpy(video))
    ref = jm.apply({"params": jparams}, video, method=jm.encode_video)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _jax_init(cfg):
    jm = JaxVALOR(cfg)
    params = jm.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                     tiny_batch(), parse_task(TASK), True, True)["params"]
    return jm, params


def _losses(jm, jparams, sd, cfg):
    """(JAX losses, port losses) of the tiny batch under the same weights."""
    spec = parse_task(TASK)
    batch = tiny_batch(seed=3)
    want = jm.apply({"params": jparams}, batch, spec, True, False)
    tm = load_model(torch_config(cfg), sd, "cpu")
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()}, spec, True, False)
    assert got.keys() == want.keys()
    return {k: float(want[k]) for k in want}, {k: float(got[k]) for k in got}


@pytest.mark.parametrize("layout", ["clip", "bert", "ast", "valor"])
def test_converted_weights_give_jax_losses(layout):
    """A tiny model loaded through each package's converter and adapter
    (from the same starting weights) gives the same losses."""
    cfg = tiny_model_config(caption_type="lm")
    jm, params = _jax_init(cfg)
    sd = {"clip": synth_clip_sd, "bert": synth_bert_sd, "ast": synth_ast_sd, "valor": synth_valor_full_sd}[layout]()
    convert = {"clip": lambda M: M.convert_clip(sd, resolution=32), "bert": lambda M: M.convert_bert(sd),
               "ast": lambda M: M.convert_ast(sd, melbins=16, target_length=32),
               "valor": lambda M: M.convert_valor_full(sd, resolution=32)}[layout]
    jparams = jadapt(convert(JC), params)
    tsd = tadapt(converted_state_dict(convert(TC)), params_from_jax(_np(params)))
    for k, v in params_from_jax(_np(jparams)).items():  # the resized position embeddings to 1e-6
        np.testing.assert_allclose(tsd[k].numpy(), v.numpy(), rtol=0, atol=1e-6 if "position" in k else 0,
                                   err_msg=k)
    want, got = _losses(jm, jparams, tsd, cfg)
    assert all(np.isfinite(v) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.fixture
def public_weights(tmp_path, monkeypatch):
    """The three public encoder files under ``$VALOR_PRETRAINED_DIR``, at the tiny widths."""
    from valor_tpu_torch.cli import build as TB

    d = tmp_path / "pretrained"
    d.mkdir()
    _write("clip_jit", synth_clip_sd(), str(d / TB._CLIP_WEIGHTS["clip_vit_base_16"]))
    _write("bert", synth_bert_sd(), str(d / TB._BERT_WEIGHTS))
    _write("ast", synth_ast_sd(), str(d / TB._AST_WEIGHTS))
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(d))
    return d


@pytest.mark.parametrize("gates", [(True, True), (True, False), (False, True), (False, False)])
def test_initialize_encoder_weights_matches_jax(public_weights, gates, caplog):
    """The CLIP file is looked up by the vision tower's name (here
    ``clip_vit_base_16``'s file holds the tiny widths), AST beside it, BERT by
    ``initial_multimodal``; the port's weights equal JAX's, tensor for tensor."""
    import logging

    from valor_tpu.cli.build import initialize_encoder_weights as jinit
    from valor_tpu_torch.cli.build import initialize_encoder_weights as tinit

    vision, multimodal = gates
    cfg = tiny_model_config(initial_vision=vision, initial_multimodal=multimodal)
    _, params = _jax_init(cfg)
    tcfg = torch_config(cfg)
    tcfg.video_encoder_type = "clip_vit_base_16"  # the file name's key; widths stay tiny
    jcfg = tiny_model_config(initial_vision=vision, initial_multimodal=multimodal,
                             video_encoder_type="clip_vit_base_16")
    with caplog.at_level(logging.INFO):
        got = tinit(tcfg, params_from_jax(_np(params)))
    want = params_from_jax(_np(jinit(jcfg, params)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
    names = [n for n, on in (("clip", vision), ("ast", vision), ("bert", multimodal)) if on]
    said = [r.getMessage() for r in caplog.records if "initialising" in r.getMessage()]
    assert said == [f"initialising {n} from {public_weights}" for n in names]
    if not names:
        assert any("random-init" in r.getMessage() for r in caplog.records)
    changed = {k for k in want if not torch.equal(want[k], params_from_jax(_np(params))[k])}
    assert bool(changed) == bool(names)


def test_train_checkpoint_file_gives_jax_first_loss(tmp_path, monkeypatch):
    """``cli.train --checkpoint <file>.pt`` (a whole VALOR checkpoint): the
    trainer's model holds JAX's ``load_converted`` + ``adapt_pretrained_params``
    weights, and its loss on the first evaluation batch equals JAX's."""
    import sys

    from tests.test_torch_cli import _flow
    from valor_tpu_torch.cli import build as TB
    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.data.synthetic import write_retrieval_dataset

    data = write_retrieval_dataset(str(tmp_path / "data"), n_train=4, n_val=4, n_frames=4,
                                   frame_size=(64, 48), wav_seconds=1.0, captions_per_train_id=2,
                                   workers=2)
    monkeypatch.setenv("VALOR_BERT_VOCAB", data["vocab"])
    monkeypatch.setenv("VALOR_CLIP_BPE", data["merges"])
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "no_weights"))
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)
    ckpt = str(tmp_path / "valor_tiny.pt")
    _write("valor", synth_valor_full_sd(), ckpt)
    jcfg = tiny_model_config(caption_type="lm", dropout=0.0, fusion_vocab=512)
    raw = {**{k: getattr(jcfg, k) for k in ("video_encoder_type", "txt_encoder_type", "video_resolution",
                                             "audio_melbins", "audio_target_length", "audio_patch_size",
                                             "fusion_hidden", "fusion_layers", "fusion_heads",
                                             "fusion_intermediate", "fusion_vocab", "audio_hidden",
                                             "audio_layers", "audio_heads", "audio_intermediate",
                                             "contra_dim", "dtype", "caption_type", "dropout")},
           "output_dir": str(tmp_path / "out"), "num_train_steps": 0, "valid_steps": 0, "first_eval": False,
           "device_fbank": False,
           "data_cfg": {"train": [_flow(data, "train", "cap%tva", 2)], "val": [_flow(data, "val", "cap%tva", 2)]}}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    trainer = main(["--config", str(tmp_path / "config.json"), "--checkpoint", ckpt, "--device", "cpu"])
    model = trainer.state.model

    jm, params = _jax_init(jcfg)
    jparams = jadapt(JC.load_converted(ckpt, resolution=32), params)
    want_sd = params_from_jax(_np(jparams))
    got_sd = model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=0,
                                   atol=1e-6 if "position" in k else 0, err_msg=k)

    cfg = load_config(str(tmp_path / "config.json"))
    (_, loader, spec), = TB.build_val_loaders(cfg, TB.build_tokenizers(cfg.model))
    batch = {k: v for k, v in next(iter(loader)).items() if isinstance(v, np.ndarray)}
    want = jm.apply({"params": jparams}, batch, parse_task("cap%tva"), True, False)
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()}, spec, True, False)
    assert np.isfinite(float(want["caption_loss"]))
    np.testing.assert_allclose(float(got["caption_loss"]), float(want["caption_loss"]), rtol=TOL, atol=TOL)
