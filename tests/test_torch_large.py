"""The larger model families of the PyTorch port against ``valor_tpu`` (fp32, CPU).

  * Every configuration that this slice makes buildable, at its full width
    (``pretrain-valor-base-moe.json``, ``pretrain-valor-large.json``,
    ``caption-mscoco.json`` at 392 px, and ``caption-msrvtt.json`` with a
    ``videoswin_base_k600_22k`` tower and BERT text): the port's
    ``state_dict`` has the keys and shapes of ``params_from_jax`` of JAX's
    tree (from ``jax.eval_shape``; the port's on the meta device: nothing is
    allocated).  The stacks are cut to ``DEPTH``'s layers (keys repeat by
    layer, so the layout is the same) and keep their widths.
  * VALOR-large's geometry at narrow depth (ViT-L/14 and CLIP-L text at one
    layer each, 56 px frames: a 4 x 4 grid): ``forward_pt`` losses and every
    gradient within 1e-4 (the whole-model tolerance), through the 1024 -> 768
    video adapter and the CLIP head at CLIP-L's 768.
  * ``caption-mscoco.json``'s tower at 392 px (ViT-B/16, one layer): a 24 x 24
    grid, 577 positions, the last 8 px of each side dropped by the patch embed
    (a VALID convolution, as the reference's ``nn.Conv2d``).  The JAX tower's
    ``nn.Conv`` pads SAME: on a 392 px frame it makes a 25 x 25 grid that its
    577-row position embedding cannot take, and raises (F9).  So the port's
    features at 392 px are held within 1e-4 to JAX's on the frame cut to its
    first 384 px, where both take the same 24 x 24 patches.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_models import _np, jax_shapes, seeded_models, tiny_batch, torch_config
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models import clip as tclip
from valor_tpu_torch.models.bridge import params_from_jax, train_model
from valor_tpu_torch.ops.layers import RNGStreams, rng_scope

TOL = 1e-4
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
FULL = {
    "moe": ("pretrain-valor-base-moe.json", {}),
    "large": ("pretrain-valor-large.json", {}),
    "mscoco_392": ("caption-mscoco.json", {}),
    "videoswin": ("caption-msrvtt.json", {"video_encoder_type": "videoswin_base_k600_22k",
                                          "txt_encoder_type": "bert_base_uncased"}),
}
DEPTH = dict(clip_vision_layers=2, clip_text_layers=2, audio_layers=2, fusion_layers=4)
LARGE_KW = dict(video_encoder_type="clip_vit_large_14", txt_encoder_type="clip_vit_large_14",
                clip_vision_layers=1, clip_text_layers=1, video_resolution=56,
                fusion_hidden=768, fusion_heads=12, dropout=0.0, caption_type="lm")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_configs_build_with_the_jax_keys(name):
    from valor_tpu.core.config import load_config as jload
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.valor import VALORModel

    path, over = FULL[name]
    over = dict(over, **DEPTH)
    cfg = load_config(str(CONFIGS / path), over).model
    jcfg = jload(str(CONFIGS / path), over).model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    port = {k: tuple(v.shape) for k, v in VALORModel(cfg, device="meta").state_dict().items()}
    # JAX's SAME-padded patch embed takes whole patches only (F9): frames cut to them
    shapes = jax_shapes(JaxVALOR(jcfg), b=1, n_frames=1, res=cfg.video_resolution // 16 * 16,
                        mel=cfg.audio_melbins, alen=cfg.audio_target_length)
    want = {}
    for path_, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        *mods, last = [k.key for k in path_]
        shape = tuple(leaf.shape)
        if last == "kernel":
            shape = shape[::-1] if len(shape) == 2 else (shape[-1], shape[-2]) + shape[:-2]
        want[".".join(mods + ["weight" if last in ("kernel", "scale", "embedding") else last])] = shape
    assert port == want
    if name == "moe":
        assert sum("moe_mlp.router" in k for k in port) == 2  # every other of 4 layers
    if name == "mscoco_392":
        assert port["clip_vision.positional_embedding"] == (577, 768)


@pytest.fixture(scope="module")
def large_models():
    return seeded_models(task="pt_contra%tva_caption%tva", res=56, **LARGE_KW)


def test_valor_large_losses_and_every_gradient(large_models):
    from valor_tpu.core.tasks import parse_task

    jm, params, _ = large_models
    task = "pt_contra%tva_caption%tva"
    batch = tiny_batch(seed=9, b=2, res=56)
    spec = parse_task(task)

    def loss(p):
        out = jm.apply({"params": p}, batch, spec, True, True)
        return sum(out.values()), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = train_model(torch_config(jm.cfg), params_from_jax(_np(params)), "cpu")
    assert tm.use_clip_head and tm.contra_dim == 768 and tm.video_dim == 1024
    assert tuple(tm.video_adapter.weight.shape) == (768, 1024) and tm.txt_dim == 768
    with rng_scope(RNGStreams(0)):
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse(task))
    sum(out.values()).backward()
    for k in ref:
        _close(out[k].detach(), ref[k])
    ref_g = params_from_jax(_np(grads))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL, err_msg=name)
    assert float(tm.video_adapter.weight.grad.abs().sum()) > 0


@torch.no_grad()
def test_mscoco_392_tower_drops_the_last_8_px():
    from valor_tpu.models import clip as jclip

    jcfg = dataclasses.replace(jclip.vision_preset("clip_vit_base_16", 392), layers=1)
    tcfg = dataclasses.replace(tclip.vision_preset("clip_vit_base_16", 392), layers=1)
    assert tcfg.grid == 24
    x = np.random.RandomState(3).randn(1, 392, 392, 3).astype(np.float32)
    jm = jclip.CLIPVisionTransformer(jcfg)
    p = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), x[:, :384, :384])["params"])
    assert p["positional_embedding"].shape == (577, 768)
    tm = tclip.CLIPVisionTransformer(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(p), strict=True)
    out = tm.eval()(torch.from_numpy(x))
    assert out.shape == (1, 577, 768)
    with pytest.raises((TypeError, ValueError)):  # F9: 25 x 25 SAME patches against 577 positions
        jm.apply({"params": p}, x)
    _close(out, jax.jit(jm.apply)({"params": p}, x[:, :384, :384]))
    edge = x.copy()
    edge[:, 384:] = 0.0
    edge[:, :, 384:] = 0.0
    np.testing.assert_array_equal(tm(torch.from_numpy(edge)).numpy(), out.numpy())
