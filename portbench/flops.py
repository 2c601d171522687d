"""The benchmark's count of VALOR's operations, from the configuration's shapes.

A product of [m, k] by [k, n] counts 2 m k n.  The count covers every product
of the model as its equations state it, whatever computes it: the patch
convolutions, every dense layer, both attention products (scores and the
weighted sum, over every head), the CLIP projections, the token-weight MLPs,
the fine score's token-pair products and its two weighted sums, and the tied
prediction head.  A training step is the forward and its backward: twice the
forward's products again (the gradients of both operands), except the patch
convolutions, whose input is data and whose backward is the weight's gradient
alone.  Nothing recomputed is counted.  Element-wise work (softmax, LayerNorm,
gelu, the losses) and the serving filterbank are not counted.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.model import TEXT, VISION, Shape


def _block(tokens: int, width: int, hidden: int) -> int:
    """A transformer layer: Q, K, V, O, the two attention products, the MLP."""
    return 8 * tokens * width * width + 4 * tokens * tokens * width + 4 * tokens * width * hidden


def _fusion_layer(seq: int, mem: int, h: int, hidden: int) -> int:
    self_attn = 8 * seq * h * h + 4 * seq * seq * h
    cross = 4 * seq * h * h + 4 * mem * h * h + 4 * seq * mem * h
    return self_attn + cross + 4 * seq * h * hidden


def encoders(s: Shape, frames: int, clips: int) -> Dict[str, int]:
    """Forward operations of one sample's towers: {'patch': convolutions, 'dense': the rest}."""
    vw, v_layers, patch = VISION[s.clip]
    grid = s.resolution // patch
    tv = grid * grid + 1
    ta_grid = (s.melbins // s.audio_patch) * (s.target_length // s.audio_patch)
    patch_ops = frames * 2 * grid * grid * 3 * patch * patch * vw
    patch_ops += clips * 2 * ta_grid * s.audio_patch * s.audio_patch * s.audio_hidden
    dense = frames * v_layers * _block(tv, vw, 4 * vw)
    dense += clips * s.audio_layers * _block(ta_grid + 1, s.audio_hidden, s.audio_intermediate)
    if vw != s.hidden:  # the video adapter into the fusion width
        dense += frames * 2 * tv * vw * s.hidden
    if s.audio_hidden != s.hidden:
        dense += clips * 2 * (ta_grid + 1) * s.audio_hidden * s.hidden
    return {"patch": patch_ops, "dense": dense, "video_tokens": frames * tv, "audio_tokens": clips * (ta_grid + 1)}


def pretrain_step(cfg: dict, batch: int, frames: int, clips: int, n_txt: int, prompt_contra: int = 0,
                  prompt_caption: int = 0, groups=("tva", "tv", "ta")) -> int:
    """Operations of one training step of ``pt_contra%<groups>_caption%<groups>``."""
    s = Shape.of(cfg)
    vw = VISION[s.clip][0]
    tw, t_layers, _, _, embed = TEXT[s.clip]
    enc = encoders(s, frames, clips)
    dense = enc["dense"]
    # the CLIP text tower over [text | prompt], then the projections and token weights
    dense += t_layers * _block(n_txt + prompt_contra, tw, 4 * tw)
    dense += 2 * n_txt * tw * embed + 2 * frames * vw * embed + 2 * clips * s.audio_hidden * embed
    for tokens in (n_txt, frames, clips):
        dense += 2 * tokens * embed * embed + 2 * tokens * embed
    cols = {"tva": frames + clips, "tv": frames, "ta": clips}
    # the fine score of each group: batch x batch items, their token pairs, two weighted sums
    pair = sum(2 * batch * batch * (n_txt * cols[g] * embed + n_txt + cols[g]) for g in groups)
    mem = {"tva": enc["video_tokens"] + enc["audio_tokens"], "tv": enc["video_tokens"], "ta": enc["audio_tokens"]}
    seq = n_txt + prompt_caption
    for g in groups:
        dense += s.layers * _fusion_layer(seq, mem[g], s.hidden, s.intermediate)
        dense += 2 * n_txt * s.hidden * s.hidden + 2 * n_txt * s.hidden * s.vocab
    return 3 * (batch * dense + pair) + 2 * batch * enc["patch"]


def caption_request(cfg: dict, frames: int, clips: int, max_len: int) -> int:
    """Forward operations of one greedy caption of ``max_len`` steps over
    [video | audio]: the towers, the media K/V projected once, and every
    step's fusion pass over the whole buffer (BOS, the tokens, the MASK) with
    the head on every position, as the decode computes it."""
    s = Shape.of(cfg)
    enc = encoders(s, frames, clips)
    mem = enc["video_tokens"] + enc["audio_tokens"]
    seq = max_len + 2
    kv = s.layers * 4 * mem * s.hidden * s.hidden
    layer = _fusion_layer(seq, mem, s.hidden, s.intermediate) - 4 * mem * s.hidden * s.hidden
    step = s.layers * layer + 2 * seq * s.hidden * s.hidden + 2 * seq * s.hidden * s.vocab
    return enc["patch"] + enc["dense"] + kv + max_len * step

