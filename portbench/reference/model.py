"""Plain PyTorch reference of VALOR, fp32, for the benchmark's correctness check.

A straightforward reading of the architecture that the benchmark's cells run
(VALOR, arXiv:2304.08345; the layer equations as the JAX package writes them):

  * CLIP ViT over each frame (patch conv, class token, position embedding,
    ln_pre, pre-norm blocks with QuickGELU, ln_post; every token kept);
  * the CLIP text tower with VALOR's prompt rows under the causal-prefix mask;
  * AST over each audio clip (16 x 16 patches, exact gelu, LN eps 1e-12,
    dropout after the position embedding and on both residual branches);
  * the 12-layer post-norm BERT fusion encoder with ``va_concate``
    cross-attention to [video | audio], the tied-embedding prediction head;
  * the fine-grained contrastive loss over tva, tv and ta, and the uniMLM
    caption loss (60 % of the tokens masked) over the same groups;
  * the decode step of greedy captioning ([BOS, tokens..., MASK] scored at
    the MASK), with the device filterbank of ``fbank.py`` for waveforms.

Everything is fp32 (``Numerics.fp32``); the caller turns TF32 off.  The
control of the check (``Numerics.fp8``) computes every product that the
program runs in bf16 as fp8 training does: operands in float8 e4m3, the
gradients through them in e5m2, one scale a tensor.  Random
draws (dropout, token masking) follow the seeded streams that the program
documents: each draw seeds a generator on the tensor's device from (seed,
stream, draw count), each encoder layer forks its own streams, so the same
seed draws the same masks here.  Parameters carry the same names as the
program's ``state_dict``, so one set of tensors loads into both.  Nothing
here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e4
BOS, EOS, MASK, MASK_RANGE_START = 101, 102, 103, 106
MAX_FRAMES = 32
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_MASK64 = (1 << 63) - 1


# -- numerics -----------------------------------------------------------------
def _fake_quant(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one scale a tensor (its largest
    magnitude to the type's largest value), and back."""
    scale = largest / t.detach().abs().amax().float().clamp_min(1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _FP8(torch.autograd.Function):
    """An fp8 product operand as fp8 training takes it: e4m3 forward, and the
    gradient that flows back through it rounded to e5m2, each scaled."""

    @staticmethod
    def forward(ctx, t):
        return _fake_quant(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _fake_quant(grad, torch.float8_e5m2, 57344.0)


class Numerics:
    """What the reference does to the operands of a product: nothing (fp32),
    a round trip through bfloat16 (a witness of what the configuration's bf16
    products alone do), or fp8 as fp8 training computes a product (the
    control): each operand in e4m3 and the gradients through it in e5m2,
    with one scale a tensor."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"numerics {kind!r}: fp32, bf16 or fp8")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return t
        if self.kind == "bf16":
            return t.to(torch.bfloat16).to(t.dtype)
        return _FP8.apply(t)


# -- seeded streams -------------------------------------------------------------
def mix(*vals: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each in turn)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h + (v & _MASK64) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & _MASK64


class Streams:
    """Named random streams of one forward: a draw seeds a generator from
    (seed, stream, count); ``fork`` gives a layer streams of its own."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.counts: Dict[str, int] = {}

    def generator(self, device, stream: str) -> torch.Generator:
        n = self.counts.get(stream, 0)
        self.counts[stream] = n + 1
        return torch.Generator(device=device).manual_seed(mix(self.seed, sum(map(ord, stream)), n))

    def fork_seed(self) -> int:
        n = self.counts.get("fork", 0)
        self.counts["fork"] = n + 1
        return mix(self.seed, 0x666F726B, n)


def dropout(x: torch.Tensor, rate: float, rng: Optional[Streams]) -> torch.Tensor:
    if rng is None or rate <= 0.0:
        return x
    g = rng.generator(x.device, "dropout")
    keep = torch.rand(tuple(x.shape), generator=g, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# -- configuration ----------------------------------------------------------------
VISION = {  # width, layers, patch
    "clip_vit_base_16": (768, 12, 16),
    "clip_vit_large_14": (1024, 24, 14),
    "clip_vit_tiny": (32, 2, 16),
}
TEXT = {  # width, layers, vocab, context, embed_dim
    "clip_vit_base_16": (512, 12, 49408, 77, 512),
    "clip_vit_large_14": (768, 12, 49408, 77, 768),
    "clip_vit_tiny": (32, 2, 512, 77, 16),
}
HEADS = {"clip_vit_tiny": 2}  # else width // 64


@dataclasses.dataclass
class Shape:
    """The sizes the reference needs, read from a VALOR config dict."""

    clip: str
    resolution: int
    melbins: int
    target_length: int
    audio_patch: int
    audio_hidden: int
    audio_layers: int
    audio_heads: int
    audio_intermediate: int
    hidden: int
    layers: int
    heads: int
    intermediate: int
    vocab: int
    dropout: float
    use_task_prompt: bool

    @classmethod
    def of(cls, cfg: dict) -> "Shape":
        g = cfg.get
        checks = {"video_encoder_type": g("video_encoder_type", "clip_vit_base_16"),
                  "txt_encoder_type": g("txt_encoder_type", "clip_vit_base_16"),
                  "audio_encoder_type": g("audio_encoder_type", "ast"),
                  "contra_type": g("contra_type", "fine"), "caption_type": g("caption_type", "unimlm"),
                  "cross_attn_type": g("cross_attn_type", "va_concate")}
        if (checks["video_encoder_type"] != checks["txt_encoder_type"]
                or checks["video_encoder_type"] not in VISION or checks["audio_encoder_type"] != "ast"
                or checks["contra_type"] != "fine" or checks["caption_type"] != "unimlm"
                or checks["cross_attn_type"] != "va_concate" or not g("multimodal_use_cross_attn", True)
                or g("fusion_moe_experts", 0) or g("fusion_cross_attn_kv_heads", 0)
                or g("full_masker", False) or g("label_smoothing", 0.0) or g("fineweight_type", "two") != "two"
                or g("late_fusion", False) or not g("init_clip_head", True)):
            raise NotImplementedError(f"the reference covers VALOR's pretraining architecture only: {checks}")
        return cls(
            clip=checks["video_encoder_type"], resolution=g("video_resolution", 224),
            melbins=g("audio_melbins", 64), target_length=g("audio_target_length", 512),
            audio_patch=g("audio_patch_size", 16), audio_hidden=g("audio_hidden", 768),
            audio_layers=g("audio_layers", 12), audio_heads=g("audio_heads", 12),
            audio_intermediate=g("audio_intermediate", 3072), hidden=g("fusion_hidden", 768),
            layers=g("fusion_layers", 12), heads=g("fusion_heads", 12),
            intermediate=g("fusion_intermediate", 3072), vocab=g("fusion_vocab", 30522),
            dropout=g("dropout", 0.1), use_task_prompt=g("use_task_prompt", False),
        )


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape))


# -- layers -------------------------------------------------------------------------
class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = _p(dim)
        self.bias = _p(dim)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


class Dense(nn.Module):
    def __init__(self, num: Numerics, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.num = num
        self.weight = _p(n_out, n_in)
        self.bias = _p(n_out) if bias else None

    def forward(self, x):
        return F.linear(self.num(x), self.num(self.weight), self.bias)


class Attention(nn.Module):
    """Multi-head attention; scores in fp32 with additive bias terms; dropout on
    the merged heads before the output projection."""

    def __init__(self, num: Numerics, width: int, heads: int, rate: float = 0.0):
        super().__init__()
        self.num, self.heads, self.rate = num, heads, rate
        self.query = Dense(num, width, width)
        self.key = Dense(num, width, width)
        self.value = Dense(num, width, width)
        self.out = Dense(num, width, width)

    def split(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

    def kv(self, mem):
        return self.split(self.key(mem)), self.split(self.value(mem))

    def forward(self, x, mem=None, bias: Sequence[torch.Tensor] = (), rng=None, kv=None):
        q = self.split(self.query(x))
        k, v = kv if kv is not None else self.kv(x if mem is None else mem)
        s = torch.matmul(self.num(q), self.num(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        for term in bias:
            s = s + term
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(self.num(p), self.num(v))
        b, h, n, d = o.shape
        o = o.transpose(1, 2).reshape(b, n, h * d)
        return self.out(dropout(o, self.rate, rng))


class Mlp(nn.Module):
    def __init__(self, num: Numerics, width: int, hidden: int, act: str):
        super().__init__()
        self.act = act
        self.fc1 = Dense(num, width, hidden)
        self.fc2 = Dense(num, hidden, width)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class PreNorm(nn.Module):
    """CLIP and AST blocks: x + drop(attn(ln1 x)), then x + drop(mlp(ln2 x))."""

    def __init__(self, num, width, heads, hidden, act, eps, rate=0.0):
        super().__init__()
        self.rate = rate
        self.ln1 = LayerNorm(width, eps)
        self.attn = Attention(num, width, heads)
        self.ln2 = LayerNorm(width, eps)
        self.mlp = Mlp(num, width, hidden, act)

    def forward(self, rng, x, bias=()):
        h = self.ln1(x)
        x = x + dropout(self.attn(h, None, bias), self.rate, rng)
        return x + dropout(self.mlp(self.ln2(x)), self.rate, rng)


def run_layers(layers, rng: Optional[Streams], remat: bool, x, *args):
    """Each layer in streams forked from ``rng`` (one fork a layer call, as the
    program forks them), under activation checkpointing when ``remat``."""
    for layer in layers:
        seed = rng.fork_seed() if rng is not None else None

        def fn(x_, *a, _layer=layer, _seed=seed):
            return _layer(None if _seed is None else Streams(_seed), x_, *a)

        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, x, *args, use_reentrant=False)
        else:
            x = fn(x, *args)
    return x


def key_bias(key_mask: torch.Tensor, text_len: int, causal: bool) -> Tuple[torch.Tensor, ...]:
    """Padding term [B, 1, 1, L] and, under the causal-prefix mask, the
    structural term: causal within the text, text keys hidden from the rest."""
    pad = ((1.0 - key_mask) * NEG_INF)[:, None, None, :]
    if not (causal and text_len > 0):
        return (pad,)
    total = key_mask.shape[1]
    qi = torch.arange(total, device=key_mask.device)[:, None]
    ki = torch.arange(total, device=key_mask.device)[None, :]
    allowed = torch.where(ki < text_len, (qi < text_len) & (ki <= qi), True).float()
    return pad, ((1.0 - allowed) * NEG_INF)[None, None]


# -- towers -------------------------------------------------------------------------
class Vision(nn.Module):
    def __init__(self, num, clip: str, resolution: int):
        super().__init__()
        w, n_layers, patch = VISION[clip]
        self.num, self.patch, self.width = num, patch, w
        grid = resolution // patch
        self.patch_embed = nn.Module()
        self.patch_embed.weight = _p(w, 3, patch, patch)
        self.class_embedding = _p(w)
        self.positional_embedding = _p(grid * grid + 1, w)
        self.ln_pre = LayerNorm(w, 1e-5)
        self.blocks = [PreNorm(num, w, HEADS.get(clip, w // 64), 4 * w, "quick_gelu", 1e-5) for _ in range(n_layers)]
        for i, b in enumerate(self.blocks):
            self.add_module(f"block_{i}", b)
        self.ln_post = LayerNorm(w, 1e-5)

    def forward(self, pixels, rng, remat):  # [B, H, W, 3] normalised
        x = F.conv2d(self.num(pixels.permute(0, 3, 1, 2)), self.num(self.patch_embed.weight), stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.class_embedding.expand(x.shape[0], 1, -1), x], 1) + self.positional_embedding
        x = run_layers(self.blocks, rng, remat, self.ln_pre(x))
        return self.ln_post(x)


class Text(nn.Module):
    def __init__(self, num, clip: str):
        super().__init__()
        w, n_layers, vocab, ctx, _ = TEXT[clip]
        self.token_embedding = _p(vocab, w)
        self.positional_embedding = _p(ctx, w)
        self.prompt_embedding = _p(1, w)
        self.blocks = [PreNorm(num, w, HEADS.get(clip, w // 64), 4 * w, "quick_gelu", 1e-5) for _ in range(n_layers)]
        for i, b in enumerate(self.blocks):
            self.add_module(f"block_{i}", b)
        self.ln_final = LayerNorm(w, 1e-5)

    def forward(self, tokens, prompt, rng, remat):
        n = tokens.shape[1]
        pos = self.positional_embedding
        feats = [F.embedding(tokens, self.token_embedding) + pos[:n]]
        masks = [(tokens != 0).float()]
        if prompt is not None:
            feats.append(F.embedding(prompt, self.token_embedding) + self.prompt_embedding[0] + pos[: prompt.shape[1]])
            masks.append((prompt != 0).float())
        x = torch.cat(feats, 1)
        bias = key_bias(torch.cat(masks, 1), n, True)
        return self.ln_final(run_layers(self.blocks, rng, remat, x, bias))[:, :n]


class Audio(nn.Module):
    def __init__(self, num, s: Shape):
        super().__init__()
        self.num, self.patch, self.rate, self.hidden = num, s.audio_patch, s.dropout, s.audio_hidden
        tokens = (s.melbins // s.audio_patch) * (s.target_length // s.audio_patch)
        self.patch_embed = nn.Module()
        self.patch_embed.weight = _p(s.audio_hidden, 1, s.audio_patch, s.audio_patch)
        self.patch_embed.bias = _p(s.audio_hidden)
        self.cls_token = _p(1, 1, s.audio_hidden)
        self.position_embeddings = _p(tokens + 1, s.audio_hidden)
        self.blocks = [PreNorm(num, s.audio_hidden, s.audio_heads, s.audio_intermediate, "gelu", 1e-12, s.dropout)
                       for _ in range(s.audio_layers)]
        for i, b in enumerate(self.blocks):
            self.add_module(f"block_{i}", b)
        self.last_layernorm = LayerNorm(s.audio_hidden, 1e-12)

    def forward(self, spec, rng, remat):  # [B, mel, T]
        x = F.conv2d(self.num(spec[:, None]), self.num(self.patch_embed.weight), self.patch_embed.bias,
                     stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, -1), x], 1) + self.position_embeddings
        x = run_layers(self.blocks, rng, remat, dropout(x, self.rate, rng))
        return self.last_layernorm(x)


class Residual(nn.Module):
    """ln(x + attn(x, mem))."""

    def __init__(self, num, width, heads, rate):
        super().__init__()
        self.attn = Attention(num, width, heads, rate)
        self.ln = LayerNorm(width, 1e-12)

    def forward(self, x, mem, bias, rng, kv=None):
        return self.ln(x + self.attn(x, mem, bias, rng, kv))


class FusionLayer(nn.Module):
    def __init__(self, num, s: Shape):
        super().__init__()
        self.rate = s.dropout
        self.self_attn = Residual(num, s.hidden, s.heads, s.dropout)
        self.cross_attn = Residual(num, s.hidden, s.heads, s.dropout)
        self.mlp = Mlp(num, s.hidden, s.intermediate, "gelu")
        self.out_ln = LayerNorm(s.hidden, 1e-12)

    def forward(self, rng, x, bias, mem, kv=None):
        x = self.self_attn(x, None, bias, rng)
        x = self.cross_attn(x, mem, (), rng, kv)
        return self.out_ln(x + dropout(self.mlp(x), self.rate, rng))


class Embeddings(nn.Module):
    def __init__(self, s: Shape):
        super().__init__()
        self.rate = s.dropout
        self.word_embeddings = _p(s.vocab, s.hidden)
        self.position_embeddings = _p(512, s.hidden)
        self.token_type_embeddings = _p(2, s.hidden)
        self.prompt_embedding = _p(1, s.hidden)
        self.LayerNorm = LayerNorm(s.hidden, 1e-12)

    def forward(self, ids, prompt_row: bool, rng):
        x = F.embedding(ids, self.word_embeddings) + self.position_embeddings[: ids.shape[1]][None]
        x = x + (self.prompt_embedding[0] if prompt_row else self.token_type_embeddings[0])
        return dropout(self.LayerNorm(x), self.rate, rng)


class Fusion(nn.Module):
    def __init__(self, num, s: Shape):
        super().__init__()
        self.embeddings = Embeddings(s)
        self.layers = [FusionLayer(num, s) for _ in range(s.layers)]
        for i, layer in enumerate(self.layers):
            self.add_module(f"layer_{i}", layer)

    def forward(self, tokens, prompt, mem, rng, remat, token_mask=None, cross_kv=None):
        feats = [self.embeddings(tokens, False, rng)]
        masks = [(tokens != 0).float() if token_mask is None else token_mask.float()]
        if prompt is not None:
            feats.append(self.embeddings(prompt, True, rng))
            masks.append((prompt != 0).float())
        x = torch.cat(feats, 1)
        bias = key_bias(torch.cat(masks, 1), tokens.shape[1], True)
        if cross_kv is not None:  # the decode: each layer's media K/V given
            for layer, kv in zip(self.layers, cross_kv):
                x = layer(None, x, bias, None, kv)
            return x
        return run_layers(self.layers, rng, remat, x, bias, mem)


class Head(nn.Module):
    def __init__(self, num, s: Shape):
        super().__init__()
        self.num = num
        self.dense = Dense(num, s.hidden, s.hidden)
        self.layernorm = LayerNorm(s.hidden, 1e-12)
        self.decoder_bias = _p(s.vocab)

    def forward(self, x, table):
        h = self.layernorm(F.gelu(self.dense(x)))
        return torch.matmul(self.num(h), self.num(table).t()) + self.decoder_bias


class FineWeight(nn.Module):
    def __init__(self, num, dim):
        super().__init__()
        self.fc1 = Dense(num, dim, dim)
        self.fc2 = Dense(num, dim, 1)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))[..., 0]


class Projections(nn.Module):
    def __init__(self, vision_width, text_width, embed):
        super().__init__()
        self.visual_proj = _p(vision_width, embed)
        self.text_proj = _p(text_width, embed)
        self.logit_scale = _p()


# -- losses -----------------------------------------------------------------------
def l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def masked_softmax(w, mask):
    return torch.softmax(torch.where(mask > 0, w, torch.full_like(mask, NEG_INF)), -1)


def fine_score(fa, fb, ma, mb, wa, wb):
    """Token-wise similarity [A, B]: every token pair's dot product (masked),
    the max over each side's tokens, weighted by the softmaxed token weights."""
    wa, wb = masked_softmax(wa, ma), masked_softmax(wb, mb)
    logits = torch.einsum("atd,bvd->abtv", fa, fb) * ma[:, None, :, None] * mb[None, :, None, :]
    a2b = torch.einsum("abt,at->ab", logits.amax(-1), wa)
    b2a = torch.einsum("abv,bv->ab", logits.amax(-2), wb)
    return 0.5 * (a2b + b2a)


def contrastive_loss(score, temp):
    s = score / temp
    return 0.5 * ((-torch.diagonal(torch.log_softmax(s, 1))).mean() + (-torch.diagonal(torch.log_softmax(s, 0))).mean())


def masked_cross_entropy(logits, labels):
    valid = (labels != -1).float()
    lse = torch.logsumexp(logits, -1)
    tgt = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - tgt) * valid).sum() / valid.sum()


def mask_tokens(gen, tokens, prob, vocab):
    """uniMLM masking: eligible positions (not 0, not pad) masked w.p.
    ``prob``, one forced where a row got none; a masked token becomes [MASK]
    (80 %), a random id (10 %) or stays (10 %).  Labels -1 where unmasked."""
    b, n = tokens.shape
    dev = tokens.device
    eligible = tokens != 0
    eligible[:, 0] = False
    rand = lambda: torch.rand((b, n), generator=gen, device=dev)  # noqa: E731
    ind = eligible & (rand() < prob)
    force = ~ind.any(1) & eligible.any(1)
    gumbel = -torch.log(-torch.log(rand().clamp_min(1e-20)))
    scores = torch.where(eligible, gumbel, torch.full_like(gumbel, -float("inf")))
    forced = torch.zeros_like(ind)
    forced[torch.arange(b, device=dev), scores.argmax(1)] = True
    ind = torch.where(force[:, None], ind | forced, ind)
    action = rand()
    rnd = torch.randint(MASK_RANGE_START, vocab, (b, n), generator=gen, device=dev, dtype=tokens.dtype)
    masked = torch.where(action < 0.8, torch.full_like(tokens, MASK), tokens)
    masked = torch.where((action >= 0.8) & (action < 0.9), rnd, masked)
    return torch.where(ind, masked, tokens), torch.where(ind, tokens, torch.full_like(tokens, -1))


# -- the model ------------------------------------------------------------------------
class ReferenceVALOR(nn.Module):
    """VALOR in plain fp32 PyTorch.  ``remat`` checkpoints every encoder layer
    (memory only: the same numbers)."""

    def __init__(self, cfg: dict, numerics: Optional[Numerics] = None, remat: bool = False):
        super().__init__()
        s = self.shape = Shape.of(cfg)
        num = self.num = numerics or Numerics("fp32")
        self.remat = remat
        vw = VISION[s.clip][0]
        tw, embed = TEXT[s.clip][0], TEXT[s.clip][4]
        self.clip_vision = Vision(num, s.clip, s.resolution)
        self.clip_proj = Projections(vw, tw, embed)
        self.clip_text = Text(num, s.clip)
        self.audio_encoder = Audio(num, s)
        self.multimodal_encoder = Fusion(num, s)
        self.cls_head = Head(num, s)
        self.contra_head_a = Dense(num, s.audio_hidden, embed, bias=False)
        self.text_fine_weight = FineWeight(num, embed)
        self.video_fine_weight = FineWeight(num, embed)
        self.audio_fine_weight = FineWeight(num, embed)
        self.contra_temp = _p()
        self.video_type_embeddings = _p(1, 1, s.hidden)
        self.audio_type_embeddings = _p(1, 1, s.hidden)
        self.video_frame_embedding = _p(1, MAX_FRAMES, s.hidden)
        self.audio_frame_embedding = _p(1, MAX_FRAMES, s.hidden)
        if vw != s.hidden:
            self.video_adapter = Dense(num, vw, s.hidden)
            self.video_adapter_ln = LayerNorm(s.hidden, 1e-12)
        if s.audio_hidden != s.hidden:
            self.audio_adapter = Dense(num, s.audio_hidden, s.hidden)
            self.audio_adapter_ln = LayerNorm(s.hidden, 1e-12)

    # encoders
    def encode_video(self, pixels, rng=None):  # uint8 [B, n, H, W, 3] -> [B, n, tokens, W]
        mean = torch.tensor(CLIP_MEAN, device=pixels.device)
        std = torch.tensor(CLIP_STD, device=pixels.device)
        x = (pixels.float() / 255.0 - mean) / std
        b, n = x.shape[:2]
        out = self.clip_vision(x.reshape((b * n,) + tuple(x.shape[2:])), rng, self.remat)
        return out.reshape(b, n, out.shape[1], out.shape[2])

    def encode_audio(self, spec, rng=None):  # [B, n, mel, T]
        b, n = spec.shape[:2]
        out = self.audio_encoder(spec.reshape((b * n,) + tuple(spec.shape[2:])), rng, self.remat)
        return out.reshape(b, n, out.shape[1], out.shape[2])

    def _fusion_input(self, out, kind: str):
        b, n, x, _ = out.shape
        if hasattr(self, f"{kind}_adapter"):
            out = getattr(self, f"{kind}_adapter_ln")(getattr(self, f"{kind}_adapter")(out))
        out = out + getattr(self, f"{kind}_frame_embedding")[:, :n, None, :]
        return out.reshape(b, n * x, -1) + getattr(self, f"{kind}_type_embeddings")

    def video_input(self, video_out):
        return self._fusion_input(video_out, "video")

    def audio_input(self, audio_out):
        return self._fusion_input(audio_out, "audio")

    def logits(self, tokens, prompt, mem, rng=None, token_mask=None, cross_kv=None):
        out = self.multimodal_encoder(tokens, prompt, mem, rng, self.remat, token_mask, cross_kv)
        return self.cls_head(out[:, : tokens.shape[1]], self.multimodal_encoder.embeddings.word_embeddings)

    # pretraining
    def pretrain_losses(self, batch: Dict[str, torch.Tensor], seed: int,
                        groups: Sequence[str] = ("tva", "tv", "ta")) -> Dict[str, torch.Tensor]:
        """The contrastive and caption losses of ``pt_contra%<groups>_caption%<groups>``
        on ``batch`` (the collate layout), with dropout and masks from ``seed``."""
        rng = Streams(seed)
        num = self.num
        prompt_c, prompt_cap = batch.get("prompt_tokens_contra"), batch.get("prompt_tokens_caption")
        video_out = self.encode_video(batch["video_pixels"], rng)
        audio_out = self.encode_audio(batch["audio_spectrograms"], rng)
        clip_tokens = batch["clip_tokens"]
        b = clip_tokens.shape[0]
        if prompt_c is not None:
            prompt_c = prompt_c.expand(b, -1)
        ft = l2_normalize(torch.matmul(num(self.clip_text(clip_tokens, prompt_c, rng, self.remat)),
                                       num(self.clip_proj.text_proj)))
        fv = l2_normalize(torch.matmul(num(video_out[:, :, 0]), num(self.clip_proj.visual_proj)))
        fa = l2_normalize(self.contra_head_a(audio_out[:, :, 0]))
        parts = {"t": (ft, (clip_tokens != 0).float(), self.text_fine_weight(ft)),
                 "v": (fv, torch.ones(fv.shape[:2], device=fv.device), self.video_fine_weight(fv)),
                 "a": (fa, torch.ones(fa.shape[:2], device=fa.device), self.audio_fine_weight(fa))}
        temp = 1.0 / torch.exp(self.clip_proj.logit_scale)
        contra = []
        for g in groups:
            cols = [parts[k] for k in g[1:]]
            cb = tuple(torch.cat([c[i] for c in cols], 1) for i in range(3))
            contra.append(contrastive_loss(fine_score(*parts["t"][:1], cb[0], parts["t"][1], cb[1],
                                                      parts["t"][2], cb[2]), temp))
        video_in, audio_in = self.video_input(video_out), self.audio_input(audio_out)
        bert = batch["bert_tokens"]
        txt_in, labels = mask_tokens(rng.generator(bert.device, "mask"), bert, 0.6, self.shape.vocab)
        if prompt_cap is not None:
            prompt_cap = prompt_cap.expand(b, -1)
        caption = []
        for g in groups:
            mem = [m for k, m in (("v", video_in), ("a", audio_in)) if k in g]
            caption.append(masked_cross_entropy(self.logits(txt_in, prompt_cap, torch.cat(mem, 1), rng), labels))
        return {"contra_loss": sum(contra) / len(contra), "caption_loss": sum(caption) / len(caption)}

    # captioning
    def cross_kv(self, mem):
        return [layer.cross_attn.attn.kv(mem) for layer in self.multimodal_encoder.layers]

    def step_logits(self, served: torch.Tensor, cross_kv, prompt=None) -> torch.Tensor:
        """The decode's logits at every step of one request, teacher-forced on
        its ``served`` tokens [L]: step t scores [BOS, served[:t], MASK] at the
        MASK.  Returns [L, V]."""
        n = served.shape[0]
        width = n + 2
        pos = torch.arange(width, device=served.device)
        buf = torch.zeros((n, width), dtype=torch.long, device=served.device)
        buf[:, 0] = BOS
        rows = torch.arange(n, device=served.device)
        prefix = pos[None, 1:n + 1] <= rows[:, None]  # [n, n]: buffer slot j + 1 holds served[j] where j < t
        buf[:, 1:n + 1] = torch.where(prefix, served[None, :], torch.zeros_like(buf[:, 1:n + 1]))
        buf[rows, rows + 1] = MASK
        mask = (pos[None] <= (rows + 1)[:, None]).float()
        kv = [(k.expand(n, -1, -1, -1), v.expand(n, -1, -1, -1)) for k, v in cross_kv]
        logits = self.logits(buf, prompt, None, None, mask, kv)
        return logits[rows, rows + 1]


def parameter_kinds(model: nn.Module) -> Dict[str, str]:
    """name -> what the weights of the benchmark draw for it: 'one', 'zero',
    'logit_scale', 'temp', 'fan_in' (N(0, 1/fan_in)) or 'embed' (N(0, 0.02))."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            if isinstance(mod, LayerNorm):
                kind = "one" if p_name == "weight" else "zero"
            elif p_name in ("bias", "decoder_bias"):
                kind = "zero"
            elif p_name == "logit_scale":
                kind = "logit_scale"
            elif p_name == "contra_temp":
                kind = "temp"
            elif p_name == "weight" or p_name in ("visual_proj", "text_proj"):
                kind = "fan_in"
            else:
                kind = "embed"
            out[name] = kind
    return out


def fan_in(name: str, shape) -> int:
    """Inputs of a weight: [out, in, ...] for Dense and conv, [in, out] for the CLIP projections."""
    if name.endswith(("visual_proj", "text_proj")):
        return int(shape[0])
    return int(np.prod(shape[1:]))
