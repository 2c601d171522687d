"""AST audio spectrogram transformer (counterpart of ``valor_tpu/models/ast.py``).

A 16x16 stride-16 convolution over a 1-channel [melbins, target_length]
log-mel image gives (melbins/16) * (target_length/16) patch tokens, ordered
row-major over (freq, time); a CLS token is prepended and a learned position
embedding added; then pre-norm layers (exact gelu, LN eps 1e-12) and a final
LayerNorm.  In training mode, dropout after the position embedding and on
both residual branches of every layer.  At 64 x 512 that is 129 tokens per clip.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from valor_tpu_torch.ops.layers import LayerNorm, PreNormLayer, _param, dropout, run_layer


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    melbins: int = 64
    target_length: int = 512
    patch_size: int = 16
    dropout: float = 0.1  # training mode only

    @property
    def tokens_per_clip(self) -> int:
        return (self.melbins // self.patch_size) * (self.target_length // self.patch_size)


class ASTEncoder(nn.Module):
    """[B, melbins, target_length] log-mel -> [B, 1 + tokens, hidden]."""

    def __init__(self, cfg: ASTConfig, dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        p = c.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.weight = _param((c.hidden_size, 1, p, p), device)
        self.patch_embed.bias = _param((c.hidden_size,), device)
        self.cls_token = _param((1, 1, c.hidden_size), device)
        self.position_embeddings = _param((c.tokens_per_clip + 1, c.hidden_size), device)
        for i in range(c.layers):
            self.add_module(f"block_{i}", PreNormLayer(
                c.hidden_size, c.heads, c.intermediate, "gelu", 1e-12, dtype, device, c.dropout))
        self.last_layernorm = LayerNorm(c.hidden_size, 1e-12, dtype, device)

    def forward(self, spectrogram: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = F.conv2d(
            spectrogram.to(self.dtype)[:, None],
            self.patch_embed.weight.to(self.dtype),
            self.patch_embed.bias.to(self.dtype),
            stride=c.patch_size,
        )
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, tokens, C], row-major (freq, time)
        cls = self.cls_token.to(self.dtype).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(self.dtype)
        x = dropout(x, c.dropout, self.training)
        for i in range(c.layers):
            x = run_layer(getattr(self, f"block_{i}"), self.remat, x)
        return self.last_layernorm(x)
