"""VideoSwin 3D video tower (counterpart of ``valor_tpu/models/videoswin.py``).

  * Patch embed: a +1 temporal pad, the frame padded to patch multiples, then a
    (2, 4, 4) Conv3D with temporal stride 1 and VALID padding (channels last
    after it), and LayerNorm.
  * Stages of Swin blocks at widths C, 2C, 4C, 8C with PatchMerging (2 x 2
    spatial merge) between them and a final LayerNorm; every LayerNorm at eps
    1e-5 goes through the K1 kernels (``ops.layers.LayerNorm``).
  * A block: pre-norm window attention with a learned relative-position bias
    table (a raw parameter, [(2wd-1)(2wh-1)(2ww-1), heads]) and, on odd
    blocks, windows shifted by half a window (``torch.roll``) under a
    per-window additive mask; then a pre-norm GELU MLP.  Scores and softmax in
    fp32.  The window is clamped to the volume where the volume is smaller
    (shift 0 on that axis), while the table keeps the configured window's
    layout, as the JAX package and the reference read it.

The window geometry (``effective_window``, ``window_partition``,
``window_reverse``, the shift mask and the relative index) is this module's own
copy; the masks are numpy, made once a shape and kept on the device.
The Conv3D is ``F.conv3d``: the JAX package computes it with ``nn.Conv``,
outside Pallas.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from valor_tpu_torch.ops.layers import Dense, LayerNorm, MlpBlock, _param, run_layer
from valor_tpu_torch.parallel.collectives import copy_to_model

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    time_stride: int = 1
    mlp_ratio: float = 4.0
    qkv_bias: bool = True

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


_PRESETS = {
    "videoswin_small_k400_1k": SwinConfig(embed_dim=96, num_heads=(3, 6, 12, 24)),
    "videoswin_base_k400_1k": SwinConfig(embed_dim=128, num_heads=(4, 8, 16, 32)),
    "videoswin_base_k400_22k": SwinConfig(embed_dim=128, num_heads=(4, 8, 16, 32)),
    "videoswin_base_k600_22k": SwinConfig(embed_dim=128, num_heads=(4, 8, 16, 32)),
    # scaled-down variant for unit tests
    "videoswin_tiny_test": SwinConfig(
        embed_dim=8, depths=(1, 1), num_heads=(2, 2), window_size=(2, 2, 2)
    ),
}


def swin_preset(name: str) -> SwinConfig:
    return _PRESETS[name]


# -- window geometry ---------------------------------------------------------

def effective_window(dims: Sequence[int], window: Sequence[int],
                     shift: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The window clamped to the volume, with the shift zeroed on each clamped axis."""
    w, s = list(window), list(shift)
    for i, d in enumerate(dims):
        if d <= window[i]:
            w[i] = d
            s[i] = 0
    return tuple(w), tuple(s)


def window_partition(x: torch.Tensor, w: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wD*wH*wW, C]."""
    b, d, h, ww, c = x.shape
    x = x.reshape(b, d // w[0], w[0], h // w[1], w[1], ww // w[2], w[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, w[0] * w[1] * w[2], c)


def window_reverse(windows: torch.Tensor, w: Sequence[int], b: int, d: int, h: int,
                   ww: int) -> torch.Tensor:
    c = windows.shape[-1]
    x = windows.reshape(b, d // w[0], h // w[1], ww // w[2], w[0], w[1], w[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, ww, c)


def np_shift_mask(dims, window, shift) -> Optional[np.ndarray]:
    """[nW, n, n] additive mask of the shifted windows (-100 between tokens
    from different regions), None without a shift."""
    if not any(shift):
        return None
    d, h, w = dims
    img = np.zeros((1, d, h, w, 1), np.float32)
    cnt = 0
    for ds in (slice(-window[0]), slice(-window[0], -shift[0] or None), slice(-shift[0] or d, None)):
        for hs in (slice(-window[1]), slice(-window[1], -shift[1] or None), slice(-shift[1] or h, None)):
            for ws in (slice(-window[2]), slice(-window[2], -shift[2] or None), slice(-shift[2] or w, None)):
                img[:, ds, hs, ws, :] = cnt
                cnt += 1
    n = window[0] * window[1] * window[2]
    win = (
        img.reshape(1, d // window[0], window[0], h // window[1], window[1], w // window[2], window[2], 1)
        .transpose(0, 1, 3, 5, 2, 4, 6, 7)
        .reshape(-1, n)
    )
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def np_relative_index(window) -> np.ndarray:
    """[n, n] row of the relative-position bias table for each token pair."""
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in window], indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window[0] - 1
    rel[:, :, 1] += window[1] - 1
    rel[:, :, 2] += window[2] - 1
    rel[:, :, 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[:, :, 1] *= 2 * window[2] - 1
    return rel.sum(-1)


_ON_DEVICE: Dict[tuple, torch.Tensor] = {}  # (kind, geometry, device) -> tensor


def _device_array(kind: str, fn, device, *geometry) -> Optional[torch.Tensor]:
    """``fn(*geometry)`` as a tensor on ``device``, made once a key."""
    key = (kind, geometry, str(device))
    if key not in _ON_DEVICE:
        arr = fn(*geometry)
        _ON_DEVICE[key] = None if arr is None else torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return _ON_DEVICE[key]


# -- modules -------------------------------------------------------------------

class WindowAttention3D(nn.Module):
    """Window attention with a relative-position bias.  Under tensor
    parallelism (``tensor_parallel``, ``parallel/partition.py``) ``num_heads``
    is this model rank's, heads ``head_offset`` on: ``qkv`` holds their rows of
    q, k and v, the bias table (whole on every rank) is read at their columns,
    and ``proj`` is row-parallel."""

    tensor_parallel = False
    head_offset = 0

    def __init__(self, dim: int, window: Tuple[int, int, int], num_heads: int,
                 qkv_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.window = tuple(window)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, use_bias=qkv_bias, dtype=dtype, device=device)
        size = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
        self.relative_position_bias_table = _param((size, num_heads), device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B_, N, C] windows; mask [nW, N, N] or None."""
        if self.tensor_parallel:
            x = copy_to_model(x)
        b_, n, _ = x.shape
        h = self.num_heads
        head = self.head_dim
        c = h * head  # this rank's width
        qkv = self.qkv(x).reshape(b_, n, 3, h, head).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (head ** -0.5), qkv[1], qkv[2]
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        idx = _device_array("relative_index", np_relative_index, x.device, self.window)
        idx = idx[:n, :n].reshape(-1)
        table = self.relative_position_bias_table
        if self.tensor_parallel:
            table = table[:, self.head_offset : self.head_offset + h]
        bias = table[idx].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, h, n, n) + mask[None, :, None]).reshape(b_, h, n, n)
        probs = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int, int],
                 shift: Tuple[int, int, int], mlp_ratio: float, qkv_bias: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = LayerNorm(dim, LN_EPS, dtype, device)
        self.attn = WindowAttention3D(dim, window, num_heads, qkv_bias, dtype, device)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype, device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), "gelu", dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, H, W, C]."""
        b, d, h, w, _ = x.shape
        window, shift = effective_window((d, h, w), self.window, self.shift)
        shortcut = x
        x = self.norm1(x)
        pd, ph, pw = (-d) % window[0], (-h) % window[1], (-w) % window[2]
        x = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pd))
        dp, hp, wp = d + pd, h + ph, w + pw
        mask = None
        if any(shift):
            x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
            mask = _device_array("shift_mask", np_shift_mask, x.device, (dp, hp, wp), window, shift)
        wins = self.attn(window_partition(x, window), mask)
        x = window_reverse(wins, window, b, dp, hp, wp)
        if any(shift):
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        x = shortcut + x[:, :d, :h, :w]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2 x 2 spatial merge: [B, D, H, W, C] -> [B, D, H/2, W/2, 2C]."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, LN_EPS, dtype, device)
        self.reduction = Dense(4 * dim, 2 * dim, use_bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer3D(nn.Module):
    """[B, n_frames, H, W, 3] -> [B, D', H', W', C] feature volume; ``remat``
    checkpoints each block in the backward."""

    def __init__(self, cfg: SwinConfig, dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.patch_embed = nn.Module()
        self.patch_embed.weight = _param((c.embed_dim, 3) + tuple(c.patch_size), device)
        self.patch_embed.bias = _param((c.embed_dim,), device)
        self.patch_norm = LayerNorm(c.embed_dim, LN_EPS, dtype, device)
        half = tuple(s // 2 for s in c.window_size)
        self.block_names = []
        for stage, (depth, heads) in enumerate(zip(c.depths, c.num_heads)):
            dim = int(c.embed_dim * 2 ** stage)
            for blk in range(depth):
                name = f"stage{stage}_block{blk}"
                self.add_module(name, SwinBlock3D(
                    dim, heads, c.window_size, (0, 0, 0) if blk % 2 == 0 else half,
                    c.mlp_ratio, c.qkv_bias, dtype, device))
                self.block_names.append(name)
            if stage < len(c.depths) - 1:
                name = f"stage{stage}_merge"
                self.add_module(name, PatchMerging(dim, dtype, device))
                self.block_names.append(name)
        self.norm = LayerNorm(c.num_features, LN_EPS, dtype, device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dt = self.dtype
        hh, ww = video.shape[2], video.shape[3]
        x = F.pad(video.to(dt), (0, 0, 0, (-ww) % c.patch_size[2], 0, (-hh) % c.patch_size[1], 0, 1))
        x = F.conv3d(x.permute(0, 4, 1, 2, 3), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt),
                     stride=(c.time_stride, c.patch_size[1], c.patch_size[2]))
        x = self.patch_norm(x.permute(0, 2, 3, 4, 1).contiguous())
        for name in self.block_names:
            mod = getattr(self, name)
            x = run_layer(mod, self.remat, x) if isinstance(mod, SwinBlock3D) else mod(x)
        return self.norm(x)
