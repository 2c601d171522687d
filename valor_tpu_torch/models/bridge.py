"""Weights for the port: from a JAX parameter tree, or seeded at random.

``params_from_jax`` takes the flax parameter tree of ``valor_tpu`` as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``, made by
the caller) and returns the port's ``state_dict``.  The port names its modules
as the flax tree does, so a path maps one to one; these leaves change layout:

  * a flax ``Dense`` (and ``_KVDense``) kernel is [in, out]; a torch linear
    weight is [out, in];
  * a flax ``Conv`` kernel is [kh, kw, in, out] over NHWC input; a torch conv
    weight is [out, in, kh, kw];
  * a flax 3D ``Conv`` kernel (VideoSwin's patch embed) is [kt, kh, kw, in,
    out] over NDHWC input; a torch conv3d weight is [out, in, kt, kh, kw];
  * a flax ``LayerNorm`` ``scale`` and an ``Embed`` ``embedding`` are torch's
    ``weight``.

Raw parameters keep their name and layout: the CLIP text tower's
``token_embedding``, ``positional_embedding`` and ``prompt_embedding``, the
CLIP projections ``visual_proj`` and ``text_proj`` ([width, embed_dim], not
transposed), the scalars ``logit_scale`` and ``contra_temp``, the MoE layers'
``router`` [M, E] and expert stacks ``w1`` [E, M, H], ``b1`` [E, H], ``w2``
[E, H, M], ``b2`` [E, M], and VideoSwin's ``relative_position_bias_table``
[(2wd-1)(2wh-1)(2ww-1), heads].
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from valor_tpu_torch.core.config import ModelConfig
from valor_tpu_torch.core.device import resolve_device
from valor_tpu_torch.ops.layers import LayerNorm


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays) -> port ``state_dict``
    (fp32 CPU tensors).  Also maps a gradient tree of the same structure."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree):
        *mods, leaf = path
        if leaf == "kernel":
            leaf = "weight"
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        out[".".join((*mods, leaf))] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


LAWS = ("sharp", "jax")
LECUN_TRUNC = 0.87962566103423978  # std of N(0, 1) cut at +-2: flax's variance_scaling divides by it


def _trunc_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """N(0, std^2) cut at +-2 std (redrawn outside), as ``jax.random.truncated_normal(-2, 2) * std``."""
    return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _jax_law(mod, p_name: str, shape, gen: torch.Generator) -> torch.Tensor:
    """What the JAX package's ``model.init`` draws for this parameter (all but
    LayerNorms, temperatures and biases): Dense kernels, embeddings, the MoE
    router and expert stacks N(0, 0.02) (``valor_tpu/ops/layers.py:90,110,417,
    446,473``, ``ops/moe.py:130,169,174``); the patch-embed convs flax's
    ``lecun_normal``, a normal cut at +-2 sigma whose sigma is corrected so that
    the draw's std is 1/sqrt(fan_in) (``models/clip.py:101``, ``ast.py:50``,
    ``videoswin.py:255``); VideoSwin's relative-position tables
    ``truncated_normal(0.02)``, cut at +-0.04 and not corrected
    (``videoswin.py:157``); the CLIP vision class and position embeddings
    N(0, width^-0.5) (``clip.py:114,122``), the CLIP text position embedding
    N(0, 0.01) (``clip.py:169``), and the CLIP projections N(0, in^-0.5)
    (``clip.py:229,235``)."""
    from valor_tpu_torch.models.clip import CLIPTextTransformer, CLIPVisionTransformer

    if p_name == "weight" and len(shape) >= 4:  # a patch-embed conv [out, in, (kt,) kh, kw]
        fan_in = math.prod(shape[1:])
        return _trunc_normal(shape, fan_in ** -0.5 / LECUN_TRUNC, gen)
    if p_name == "relative_position_bias_table":
        return _trunc_normal(shape, 0.02, gen)
    if isinstance(mod, CLIPVisionTransformer) and p_name in ("class_embedding", "positional_embedding"):
        std = mod.cfg.width ** -0.5
    elif isinstance(mod, CLIPTextTransformer) and p_name == "positional_embedding":
        std = 0.01
    elif p_name in ("visual_proj", "text_proj"):
        std = shape[0] ** -0.5
    else:
        std = 0.02
    return torch.empty(shape).normal_(0.0, std, generator=gen)


def _sharp_law(p_name: str, shape, gen: torch.Generator) -> torch.Tensor:
    if p_name in ("visual_proj", "text_proj", "router"):
        return torch.empty(shape).normal_(0.0, shape[0] ** -0.5, generator=gen)
    if p_name in ("w1", "w2"):  # [E, in, out]
        return torch.empty(shape).normal_(0.0, shape[1] ** -0.5, generator=gen)
    if p_name == "weight":  # Dense [out, in] or conv [out, in, kh, kw]
        fan_in = math.prod(shape) // shape[0]
        return torch.empty(shape).normal_(0.0, fan_in ** -0.5, generator=gen)
    return torch.empty(shape).normal_(0.0, 0.02, generator=gen)


def init_params(cfg: ModelConfig, seed: int = 0, device=None, law: str = "sharp") -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``VALORModel(cfg)`` at any width.

    Drawn on the CPU from one ``torch.Generator`` in ``state_dict`` order, so a
    seed gives the same weights on every device; then moved to ``device`` (the
    CUDA card when None).  With either law LayerNorm scales are 1, biases 0
    (the expert biases and the decoder bias too), and the temperatures start
    where the JAX package starts them: ``logit_scale`` at log(1/0.07) and
    ``contra_temp`` at 0.07.  The rest:

      * ``law="jax"``: each parameter from the JAX package's initializer
        (``_jax_law``), as ``cli.train`` starts a run;
      * ``law="sharp"``: matmul and conv weights (2D and 3D) N(0, 1/fan_in),
        which keeps activations at unit scale so that the attention is sharp
        and each caption depends on its media (tests and the smoke run's
        serving phases rely on it), and so are the CLIP projections
        ([in, out]), the MoE router ([M, E]) and expert stacks (``w1``
        N(0, 1/M), ``w2`` N(0, 1/H)); embeddings and VideoSwin's
        relative-position bias tables N(0, 0.02)."""
    from valor_tpu_torch.models.valor import VALORModel

    if law not in LAWS:
        raise ValueError(f"init law {law!r}: one of {LAWS}")
    dev = resolve_device(device)
    shapes = VALORModel(cfg, device="meta")
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for mod_name, mod in shapes.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, LayerNorm):
                t = torch.ones(p.shape) if p_name == "weight" else torch.zeros(p.shape)
            elif p_name == "logit_scale":
                t = torch.full(p.shape, math.log(1 / 0.07))
            elif p_name == "contra_temp":
                t = torch.full(p.shape, 0.07)
            elif p_name in ("bias", "decoder_bias", "b1", "b2"):
                t = torch.zeros(p.shape)
            elif law == "jax":
                t = _jax_law(mod, p_name, tuple(p.shape), gen)
            else:
                t = _sharp_law(p_name, tuple(p.shape), gen)
            out[name] = t.to(dev)
    return out


def load_model(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor], device=None):
    """An eval-mode ``VALORModel`` on ``device`` (the CUDA card when None)
    holding ``state_dict``, with gradients off."""
    from valor_tpu_torch.models.valor import VALORModel

    model = VALORModel(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)


def train_model(cfg: ModelConfig, state_dict: Mapping[str, torch.Tensor], device=None):
    """A training-mode ``VALORModel`` on ``device`` (the CUDA card when None)
    holding ``state_dict``, with gradients on."""
    from valor_tpu_torch.models.valor import VALORModel

    model = VALORModel(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.train().requires_grad_(True)
