"""PyTorch checkpoint conversion into the flax-layout parameter tree (the
port's copy of ``valor_tpu/models/convert.py``, with numpy and torch only).

Converts the public released weights the reference consumes
(modeling.py:560-683, :512-554):
  * OpenAI CLIP jit archives (clip-vit-base-16.pt, ...) -> clip_vision/
    clip_text/clip_proj, incl. visual pos-emb bilinear resize for a new
    resolution (clip.py:470-491),
  * HuggingFace bert-base-uncased.bin -> multimodal_encoder (+ optional
    separate txt_encoder) + cls_head, with gamma/beta -> scale/bias renames
    (modeling.py:639),
  * AST audioset checkpoint (module.v.*) -> audio_encoder with the qkv
    split + pos-emb 12x101 -> (mel/16)x(len/16) bilinear resize
    (modeling.py:512-554),
  * VideoSwin checkpoints -> video_encoder,
  * a full VALOR .pt training checkpoint -> the whole tree.

The output keeps the JAX package's flax layout, so that each table reads line
for line against it: torch Linear [out, in] -> kernel [in, out] (transpose);
Conv2d [O, I, H, W] -> HWIO; Conv3d [O, I, D, H, W] -> DHWIO.
``models/bridge.py:params_from_jax`` maps such a tree to the port's
``state_dict`` (the VideoSwin tree waits for a VideoSwin tower in the port).
The resizes are ``train/checkpoints.py``'s, which stand in for
``jax.image.resize``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from valor_tpu_torch.train.checkpoints import (
    bilinear_resize_pos_embed,
    bilinear_resize_pos_embed_2d,
)


def _load_torch(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file's tensors as fp32 numpy arrays: a JIT archive (the
    released CLIP weights) first, else ``torch.load`` of a pickle, unwrapped
    from a module, a ``model`` or a ``state_dict`` entry."""
    try:
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        try:
            obj = torch.load(path, map_location="cpu", weights_only=False)
        except Exception as e:  # name the file: a run must not go on from random weights
            raise ValueError(f"{path}: neither a JIT archive nor a torch checkpoint ({type(e).__name__}: {e})") from e
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
            obj = obj["model"]
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
    return {k: v.detach().float().numpy() for k, v in obj.items() if hasattr(v, "detach")}


def _lin(sd, key):
    return {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}


def _lin_nob(sd, key):
    return {"kernel": sd[f"{key}.weight"].T}


def _ln(sd, key):
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _attn_from_inproj(sd, prefix):
    """torch nn.MultiheadAttention -> our MultiHeadAttention params."""
    w = sd[f"{prefix}.in_proj_weight"]
    b = sd[f"{prefix}.in_proj_bias"]
    c = w.shape[1]
    return {
        "query": {"kernel": w[:c].T, "bias": b[:c]},
        "key": {"kernel": w[c : 2 * c].T, "bias": b[c : 2 * c]},
        "value": {"kernel": w[2 * c :].T, "bias": b[2 * c :]},
        "out": _lin(sd, f"{prefix}.out_proj"),
    }


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


def convert_clip(path_or_sd, resolution: int = 224) -> Dict[str, Any]:
    sd = _load_torch(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    vis_layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks")})
    txt_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")})
    width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]

    vision: Dict[str, Any] = {
        "patch_embed": {"kernel": sd["visual.conv1.weight"].transpose(2, 3, 1, 0)},
        "class_embedding": sd["visual.class_embedding"],
        "ln_pre": _ln(sd, "visual.ln_pre"),
        "ln_post": _ln(sd, "visual.ln_post"),
    }
    pos = sd["visual.positional_embedding"]
    src_grid = int(round((pos.shape[0] - 1) ** 0.5))
    dst_grid = resolution // patch
    if src_grid != dst_grid:
        pos = bilinear_resize_pos_embed(pos, dst_grid)
    vision["positional_embedding"] = pos
    for i in range(vis_layers):
        p = f"visual.transformer.resblocks.{i}"
        vision[f"block_{i}"] = {
            "ln1": _ln(sd, f"{p}.ln_1"),
            "ln2": _ln(sd, f"{p}.ln_2"),
            "attn": _attn_from_inproj(sd, f"{p}.attn"),
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.c_fc"), "fc2": _lin(sd, f"{p}.mlp.c_proj")},
        }

    text: Dict[str, Any] = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final": _ln(sd, "ln_final"),
    }
    if "prompt_embedding.weight" in sd:
        text["prompt_embedding"] = sd["prompt_embedding.weight"]
    for i in range(txt_layers):
        p = f"transformer.resblocks.{i}"
        text[f"block_{i}"] = {
            "ln1": _ln(sd, f"{p}.ln_1"),
            "ln2": _ln(sd, f"{p}.ln_2"),
            "attn": _attn_from_inproj(sd, f"{p}.attn"),
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.c_fc"), "fc2": _lin(sd, f"{p}.mlp.c_proj")},
        }

    proj = {
        "visual_proj": sd["visual.proj"],
        "text_proj": sd["text_projection"],
        "logit_scale": sd["logit_scale"],
    }
    return {"clip_vision": vision, "clip_text": text, "clip_proj": proj}


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------


def convert_bert(path_or_sd, target: str = "multimodal_encoder") -> Dict[str, Any]:
    sd = _load_torch(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    sd = {
        k.replace("bert.", "").replace("gamma", "weight").replace("beta", "bias"): v
        for k, v in sd.items()
    }
    enc: Dict[str, Any] = {
        "embeddings": {
            "word_embeddings": sd["embeddings.word_embeddings.weight"],
            "position_embeddings": sd["embeddings.position_embeddings.weight"],
            "token_type_embeddings": sd["embeddings.token_type_embeddings.weight"],
            "LayerNorm": _ln(sd, "embeddings.LayerNorm"),
        }
    }
    # task-prompt type embedding (reference: model/bert.py:181, a 1-row
    # nn.Embedding used when token_type == 'prompt')
    if "embeddings.prompt_embedding.weight" in sd:
        enc["embeddings"]["prompt_embedding"] = sd["embeddings.prompt_embedding.weight"]
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("encoder.layer.")})
    for i in range(n_layers):
        p = f"encoder.layer.{i}"
        layer = {
            "self_attn": {
                "attn": {
                    "query": _lin(sd, f"{p}.attention.self.query"),
                    "key": _lin(sd, f"{p}.attention.self.key"),
                    "value": _lin(sd, f"{p}.attention.self.value"),
                    "out": _lin(sd, f"{p}.attention.output.dense"),
                },
                "ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            },
            "mlp": {
                "fc1": _lin(sd, f"{p}.intermediate.dense"),
                "fc2": _lin(sd, f"{p}.output.dense"),
            },
            "out_ln": _ln(sd, f"{p}.output.LayerNorm"),
        }
        # cross-attention blocks (VALOR-finetuned checkpoints; reference
        # BertLayer names: cross_attn / cross_attn_v / cross_attn_a with
        # .cross.{query,key,value} + .output.{dense,LayerNorm})
        for name in ("cross_attn", "cross_attn_v", "cross_attn_a"):
            key = f"{p}.{name}.cross.query.weight"
            if key in sd:
                layer[name] = {
                    "attn": {
                        "query": _lin(sd, f"{p}.{name}.cross.query"),
                        "key": _lin(sd, f"{p}.{name}.cross.key"),
                        "value": _lin(sd, f"{p}.{name}.cross.value"),
                        "out": _lin(sd, f"{p}.{name}.output.dense"),
                    },
                    "ln": _ln(sd, f"{p}.{name}.output.LayerNorm"),
                }
        enc[f"layer_{i}"] = layer
    out = {target: enc}
    if "cls.predictions.transform.dense.weight" in sd:
        out["cls_head"] = {
            "dense": _lin(sd, "cls.predictions.transform.dense"),
            "layernorm": _ln(sd, "cls.predictions.transform.LayerNorm"),
            "decoder_bias": sd["cls.predictions.bias"],
        }
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


def convert_ast(
    path_or_sd, melbins: int = 64, target_length: int = 512, patch: int = 16
) -> Dict[str, Any]:
    sd = _load_torch(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    enc: Dict[str, Any] = {
        "cls_token": sd["v.cls_token"],
        "patch_embed": {
            # AudioSet conv is [768, 1, 16, 16] -> HWIO
            "kernel": sd["v.patch_embed.proj.weight"].transpose(2, 3, 1, 0),
            "bias": sd["v.patch_embed.proj.bias"],
        },
        "last_layernorm": {"scale": sd["v.norm.weight"], "bias": sd["v.norm.bias"]},
    }
    # pos-emb: drop the distilled token, resize 12x101 -> (mel/16)x(len/16)
    # (reference: modeling.py:520-528)
    pos = sd["v.pos_embed"][0]
    cls_pos = pos[0:1]
    grid = pos[2:]
    resized = bilinear_resize_pos_embed_2d(
        np.concatenate([cls_pos, grid]),
        (12, 101),
        (melbins // patch, target_length // patch),
        has_cls=True,
    )
    enc["position_embeddings"] = resized
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("v.blocks.")})
    for i in range(n_layers):
        p = f"v.blocks.{i}"
        qkv_w = sd[f"{p}.attn.qkv.weight"]
        qkv_b = sd[f"{p}.attn.qkv.bias"]
        c = qkv_w.shape[1]
        enc[f"block_{i}"] = {
            "ln1": _ln(sd, f"{p}.norm1"),
            "ln2": _ln(sd, f"{p}.norm2"),
            "attn": {
                "query": {"kernel": qkv_w[:c].T, "bias": qkv_b[:c]},
                "key": {"kernel": qkv_w[c : 2 * c].T, "bias": qkv_b[c : 2 * c]},
                "value": {"kernel": qkv_w[2 * c :].T, "bias": qkv_b[2 * c :]},
                "out": _lin(sd, f"{p}.attn.proj"),
            },
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")},
        }
    return {"audio_encoder": enc}


# ---------------------------------------------------------------------------
# VideoSwin
# ---------------------------------------------------------------------------


def convert_videoswin(path_or_sd) -> Dict[str, Any]:
    sd = _load_torch(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    sd = {k.replace("backbone.", ""): v for k, v in sd.items()}
    enc: Dict[str, Any] = {
        "patch_embed": {
            "kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 4, 1, 0),
            "bias": sd["patch_embed.proj.bias"],
        },
        "patch_norm": _ln(sd, "patch_embed.norm"),
        "norm": _ln(sd, "norm"),
    }
    stages = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.")})
    for s in stages:
        blocks = sorted(
            {int(k.split(".")[3]) for k in sd if k.startswith(f"layers.{s}.blocks.")}
        )
        for b in blocks:
            p = f"layers.{s}.blocks.{b}"
            qkv_w = sd[f"{p}.attn.qkv.weight"]
            c = qkv_w.shape[1]
            qkv_b = sd.get(f"{p}.attn.qkv.bias")
            attn = {
                "qkv": {"kernel": qkv_w.T},
                "proj": _lin(sd, f"{p}.attn.proj"),
                "relative_position_bias_table": sd[f"{p}.attn.relative_position_bias_table"],
            }
            if qkv_b is not None:
                attn["qkv"]["bias"] = qkv_b
            enc[f"stage{s}_block{b}"] = {
                "norm1": _ln(sd, f"{p}.norm1"),
                "norm2": _ln(sd, f"{p}.norm2"),
                "attn": attn,
                "mlp": {"fc1": _lin(sd, f"{p}.mlp.fc1"), "fc2": _lin(sd, f"{p}.mlp.fc2")},
            }
        if f"layers.{s}.downsample.reduction.weight" in sd:
            enc[f"stage{s}_merge"] = {
                "norm": _ln(sd, f"layers.{s}.downsample.norm"),
                "reduction": _lin_nob(sd, f"layers.{s}.downsample.reduction"),
            }
    return {"video_encoder": enc}


# ---------------------------------------------------------------------------
# full VALOR training checkpoint
# ---------------------------------------------------------------------------


def _sub(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    n = len(prefix)
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix)}


def _convert_ast_inmodel(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """VALOR-internal AST layout -> audio_encoder tree.

    The released VALOR .pt stores the audio tower under its in-model names
    (reference: modeling.py:738-762 AudioEmbeddings `first_conv`/
    `position_embeddings`/`cls_token`; transformer.py:56-170
    `layer.N.attention.linears.{0..3}` q/k/v/out, `ff_layer.linear{1,2}`,
    `layernorm{1,2}`, `last_layernorm`) — different from the AudioSet
    artifact layout convert_ast handles (`module.v.*`).
    """
    emb = _sub(sd, "audio_embeddings.")
    enc_sd = _sub(sd, "audio_encoder.")
    enc: Dict[str, Any] = {
        "cls_token": emb["cls_token"],
        "patch_embed": {
            "kernel": emb["first_conv.weight"].transpose(2, 3, 1, 0),
            "bias": emb["first_conv.bias"],
        },
        "position_embeddings": emb["position_embeddings.weight"],
        "last_layernorm": _ln(enc_sd, "last_layernorm"),
    }
    n_layers = len({k.split(".")[1] for k in enc_sd if k.startswith("layer.")})
    for i in range(n_layers):
        p = f"layer.{i}"
        enc[f"block_{i}"] = {
            "ln1": _ln(enc_sd, f"{p}.layernorm1"),
            "ln2": _ln(enc_sd, f"{p}.layernorm2"),
            "attn": {
                "query": _lin(enc_sd, f"{p}.attention.linears.0"),
                "key": _lin(enc_sd, f"{p}.attention.linears.1"),
                "value": _lin(enc_sd, f"{p}.attention.linears.2"),
                "out": _lin(enc_sd, f"{p}.attention.linears.3"),
            },
            "mlp": {
                "fc1": _lin(enc_sd, f"{p}.ff_layer.linear1"),
                "fc2": _lin(enc_sd, f"{p}.ff_layer.linear2"),
            },
        }
    return {"audio_encoder": enc}


def _fine_weight(sd: Dict[str, np.ndarray], key: str) -> Dict[str, Any]:
    # reference Sequential(Linear, ReLU, Linear) -> indices 0 / 2
    # (pretrain.py:104-112); ours is FineWeight{fc1,fc2}
    return {"fc1": _lin(sd, f"{key}.0"), "fc2": _lin(sd, f"{key}.2")}


def convert_valor_full(path_or_sd, resolution: int = 224) -> Dict[str, Any]:
    """A released VALOR training checkpoint (.pt with the whole model's
    state_dict — README.md:53-60 model zoo) -> our full flax param tree.

    Key families (reference VALORModel attribute names):
      clip_model.*            modeling.py:569   -> clip_vision/clip_text/clip_proj
      video_encoder.*         modeling.py:583   -> video_encoder (videoswin)
      audio_embeddings.* / audio_encoder.*  modeling.py:603-605 -> audio_encoder
      multimodal_encoder.*    modeling.py:635   -> multimodal_encoder
      txt_encoder.*           modeling.py:688   -> txt_encoder (separate bert)
      cls.*                   modeling.py:651   -> cls_head
      contra_head_{t,v,a}.linear / va_fusion / *_fine_weight / contra_temp
                              pretrain.py:89-119
      *_type_embeddings / *_frame_embedding / hidden_trans_*_multimodal
                              modeling.py:341-351
    """
    sd = _load_torch(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    out: Dict[str, Any] = {}

    clip_sd = _sub(sd, "clip_model.")
    if clip_sd:
        out.update(convert_clip(clip_sd, resolution))
    if any(k.startswith("video_encoder.patch_embed") for k in sd):
        out.update(convert_videoswin(_sub(sd, "video_encoder.")))
    if any(k.startswith("audio_embeddings.") for k in sd):
        out.update(_convert_ast_inmodel(sd))
    if any(k.startswith("multimodal_encoder.") for k in sd):
        out.update(convert_bert(_sub(sd, "multimodal_encoder.")))
    txt_sd = _sub(sd, "txt_encoder.")
    # share_txt_and_multimodal / clip text towers alias existing modules;
    # only a genuinely separate bert txt encoder needs its own subtree
    if txt_sd and any(k.startswith("encoder.layer.") for k in txt_sd):
        out.update(convert_bert(txt_sd, target="txt_encoder"))

    if "cls.dense.weight" in sd:
        out["cls_head"] = {
            "dense": _lin(sd, "cls.dense"),
            "layernorm": _ln(sd, "cls.layernorm"),
            "decoder_bias": sd["cls.decoder.bias"],
        }
    for name in ("contra_head_t", "contra_head_v", "contra_head_a"):
        if f"{name}.linear.weight" in sd:
            out[name] = _lin_nob(sd, f"{name}.linear")
    if "va_fusion.weight" in sd:
        out["va_fusion"] = _lin(sd, "va_fusion")
    for name in ("text_fine_weight", "video_fine_weight", "audio_fine_weight"):
        if f"{name}.0.weight" in sd:
            out[name] = _fine_weight(sd, name)
    for name in (
        "contra_temp",
        "video_type_embeddings",
        "audio_type_embeddings",
        "video_frame_embedding",
        "audio_frame_embedding",
    ):
        if name in sd:
            out[name] = sd[name]
    # dim adapters: Sequential(Linear, FusedLayerNorm) (modeling.py:349-351)
    if "hidden_trans_video_multimodal.0.weight" in sd:
        out["video_adapter"] = _lin(sd, "hidden_trans_video_multimodal.0")
        out["video_adapter_ln"] = _ln(sd, "hidden_trans_video_multimodal.1")
    if "hidden_trans_audio_multimodal.0.weight" in sd:
        out["audio_adapter"] = _lin(sd, "hidden_trans_audio_multimodal.0")
        out["audio_adapter_ln"] = _ln(sd, "hidden_trans_audio_multimodal.1")
    return out


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def load_converted(path: str, resolution: int = 224) -> Dict[str, Any]:
    """Best-effort conversion of a torch checkpoint by key inspection."""
    sd = _load_torch(path)
    keys = set(sd)
    if any(
        k.startswith(("clip_model.", "multimodal_encoder.", "audio_embeddings."))
        for k in keys
    ):
        return convert_valor_full(sd, resolution)
    if any(k.startswith("visual.") for k in keys):
        return convert_clip(sd, resolution)
    if any("v.blocks." in k for k in keys):
        return convert_ast(sd)
    if any(k.startswith(("layers.", "backbone.layers.")) for k in keys):
        return convert_videoswin(sd)
    if any("encoder.layer." in k for k in keys):
        return convert_bert(sd)
    raise ValueError(f"unrecognised checkpoint layout: {sorted(keys)[:10]}")
