"""CLIP towers as VALOR uses them (counterpart of ``valor_tpu/models/clip.py``).

The vision tower returns all patch tokens (CLS first) after ``ln_post``: VALOR
consumes the whole token grid.  Pre-norm residual blocks with QuickGELU, LN
eps 1e-5.  Input pixels are NHWC, as in the JAX package; the patch embed is a
stride-``patch`` convolution whose tokens are ordered row-major over (h, w).
The text tower carries VALOR's extension: a learned prompt-type embedding and
[text | prompt | video | audio] inputs under the causal-prefix mask.
``CLIPProjections`` holds ``visual.proj``, ``text_projection`` and
``logit_scale`` as raw parameters in the JAX layout ([width, embed_dim]).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from valor_tpu_torch.ops.layers import LayerNorm, PreNormLayer, _param, run_layer
from valor_tpu_torch.ops.masks import concat_key_mask, fusion_attention_bias_terms


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    width: int = 768
    layers: int = 12
    patch_size: int = 16
    resolution: int = 224
    num_heads: int = 0  # 0 -> width // 64 (OpenAI convention)

    @property
    def heads(self) -> int:
        return self.num_heads or max(self.width // 64, 1)

    @property
    def grid(self) -> int:
        return self.resolution // self.patch_size


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    width: int = 512
    layers: int = 12
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512
    num_heads: int = 0  # 0 -> width // 64 (OpenAI convention)

    @property
    def heads(self) -> int:
        return self.num_heads or max(self.width // 64, 1)


_VISION_PRESETS = {
    "clip_vit_base_32": CLIPVisionConfig(width=768, layers=12, patch_size=32),
    "clip_vit_base_16": CLIPVisionConfig(width=768, layers=12, patch_size=16),
    "clip_vit_large_14": CLIPVisionConfig(width=1024, layers=24, patch_size=14),
    "clip_vit_large_14_336px": CLIPVisionConfig(
        width=1024, layers=24, patch_size=14, resolution=336
    ),
    # scaled-down variant for unit tests
    "clip_vit_tiny": CLIPVisionConfig(width=32, layers=2, patch_size=16, resolution=32, num_heads=2),
}


_TEXT_PRESETS = {
    "clip_vit_base_32": CLIPTextConfig(width=512, embed_dim=512),
    "clip_vit_base_16": CLIPTextConfig(width=512, embed_dim=512),
    "clip_vit_large_14": CLIPTextConfig(width=768, embed_dim=768),
    "clip_vit_large_14_336px": CLIPTextConfig(width=768, embed_dim=768),
    "clip_vit_tiny": CLIPTextConfig(width=32, layers=2, vocab_size=512, embed_dim=16, num_heads=2),
}


def vision_preset(name: str, resolution: Optional[int] = None) -> CLIPVisionConfig:
    cfg = _VISION_PRESETS[name]
    if resolution and resolution != cfg.resolution:
        cfg = dataclasses.replace(cfg, resolution=resolution)
    return cfg


def text_preset(name: str) -> CLIPTextConfig:
    return _TEXT_PRESETS[name]


class CLIPVisionTransformer(nn.Module):
    """ViT returning all tokens (CLS first), post-LN'd."""

    def __init__(self, cfg: CLIPVisionConfig, dtype=torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.patch_embed = nn.Module()
        self.patch_embed.weight = _param((c.width, 3, c.patch_size, c.patch_size), device)
        self.class_embedding = _param((c.width,), device)
        self.positional_embedding = _param((c.grid * c.grid + 1, c.width), device)
        self.ln_pre = LayerNorm(c.width, 1e-5, dtype, device)
        for i in range(c.layers):
            self.add_module(f"block_{i}", PreNormLayer(
                c.width, c.heads, c.width * 4, "quick_gelu", 1e-5, dtype, device))
        self.ln_post = LayerNorm(c.width, 1e-5, dtype, device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: [B, H, W, 3] (NHWC). -> [B, 1 + g*g, W]."""
        c = self.cfg
        x = F.conv2d(
            pixels.to(self.dtype).permute(0, 3, 1, 2),
            self.patch_embed.weight.to(self.dtype),
            stride=c.patch_size,
        )
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, W], row-major (h, w)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, c.width)
        x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(self.dtype)
        x = self.ln_pre(x)
        for i in range(c.layers):
            x = run_layer(getattr(self, f"block_{i}"), self.remat, x)
        return self.ln_post(x)


class CLIPTextTransformer(nn.Module):
    """CLIP text tower with VALOR's prompt and multimodal extension."""

    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.token_embedding = _param((c.vocab_size, c.width), device)
        self.positional_embedding = _param((c.context_length, c.width), device)
        self.prompt_embedding = _param((1, c.width), device)
        for i in range(c.layers):
            self.add_module(f"block_{i}", PreNormLayer(
                c.width, c.heads, c.width * 4, "quick_gelu", 1e-5, dtype, device))
        self.ln_final = LayerNorm(c.width, 1e-5, dtype, device)

    def forward(
        self,
        txt_tokens: torch.Tensor,  # [B, N] int
        task_prompt: Optional[torch.Tensor] = None,  # [B, P] int
        video_feat: Optional[torch.Tensor] = None,  # [B, Nv, W]
        audio_feat: Optional[torch.Tensor] = None,  # [B, Na, W]
        causal: bool = True,
    ) -> torch.Tensor:
        c = self.cfg
        b, n = txt_tokens.shape
        pos = self.positional_embedding
        x = F.embedding(txt_tokens, self.token_embedding).to(self.dtype) + pos[:n].to(self.dtype)
        feats = [x]
        text_mask = (txt_tokens != 0).float()
        prompt_mask = None
        if task_prompt is not None:
            p = F.embedding(task_prompt, self.token_embedding).to(self.dtype)
            p = p + self.prompt_embedding[0].to(self.dtype)
            p = p + pos[: task_prompt.shape[1]].to(self.dtype)
            feats.append(p)
            prompt_mask = (task_prompt != 0).float()
        n_video = video_feat.shape[1] if video_feat is not None else 0
        n_audio = audio_feat.shape[1] if audio_feat is not None else 0
        if video_feat is not None:
            feats.append(video_feat.to(self.dtype))
        if audio_feat is not None:
            feats.append(audio_feat.to(self.dtype))
        x = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
        key_mask = concat_key_mask(text_mask, prompt_mask, n_video, n_audio, b, x.device)
        bias = fusion_attention_bias_terms(key_mask, n if causal else 0, causal)
        for i in range(c.layers):
            x = run_layer(getattr(self, f"block_{i}"), self.remat, x, bias)
        return self.ln_final(x)


class CLIPProjections(nn.Module):
    """visual.proj / text_projection / logit_scale as raw parameters, so that
    VALOR's ``init_clip_head`` contrastive heads work."""

    def __init__(self, vision_width: int, text_width: int, embed_dim: int, device=None):
        super().__init__()
        self.visual_proj = _param((vision_width, embed_dim), device)
        self.text_proj = _param((text_width, embed_dim), device)
        self.logit_scale = _param((), device)

    def project_visual(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.visual_proj.to(x.dtype))

    def project_text(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.text_proj.to(x.dtype))

    def temperature(self) -> torch.Tensor:
        """1 / exp(logit_scale)."""
        return 1.0 / torch.exp(self.logit_scale)
