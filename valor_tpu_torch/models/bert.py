"""BERT multimodal fusion encoder (counterpart of ``valor_tpu/models/bert.py``).

  * BertEmbeddings: word + position + token-type embeddings, LN(1e-12), with a
    one-row prompt-type embedding; in full-masker mode the mask-stream half
    reuses the first half's positions shifted by one.
  * Dropout (training mode): after the embedding LN, on each attention's
    output before its projection, and on the FFN output, as the JAX package.
  * Post-norm BertFusionLayer with optional per-layer cross-attention to video
    and audio in four topologies: va_concate, va_parallel, video_audio,
    audio_video.  ``cross_attn_kv_heads`` > 0 projects the cross-attention K/V
    to that many heads (grouped-query attention), and ``moe_experts`` > 0 swaps
    the FFN of every ``moe_every``-th layer for ``ops.moe.MoEMlpBlock``
    (``moe_mlp``), whose load-balancing aux each call sows
    (``ops.layers.sow``).
  * BertFusionEncoder: [text | prompt | video | audio] input assembly with the
    bidirectional, causal-prefix or full-masker mask; video and audio join the
    sequence only when cross-attention is off.  ``cross_kv_list`` carries the
    per-layer cross-attention K/V that the decode projects once per rollout;
    without cross-attention ``precompute_ctx_kv`` and ``decode_with_ctx`` cache
    the [prompt | media] context's self-attention K/V once per rollout.
  * Pipeline parallelism (``parallel/pipeline.py``): with ``pipeline_stages``
    S a training step's layer stack runs S stages over the pipe axis where
    the pipeline is installed and the batch microbatches
    (``_maybe_pipeline``), the layers split as the JAX package's
    ``_reshape_stages`` splits them; elsewhere (one process, evaluation, the
    decode) it runs as a plain stack.  MoE layers and stages are refused
    together, and so are layers that do not divide into S x V blocks, with the
    JAX package's messages.
  * Sequence parallelism (``parallel/activations.py``): where
    ``sequence_sharded`` engages, the forward runs the residual stream between
    layers as this model rank's [B, S/M, D] chunk; each sublayer gathers the
    sequence and scatters its output, and the residual adds, dropout and
    LayerNorms run on the chunk.  After the last layer the sequence is
    gathered whole.  The context-K/V decode (``precompute_ctx_kv``,
    ``decode_with_ctx``) runs unsplit, as the JAX package's does, and so does
    a pipelined stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from valor_tpu_torch.ops.layers import (
    Dense, LayerNorm, MlpBlock, MultiHeadAttention, _param, dropout, run_layer, sow,
)
from valor_tpu_torch.ops.moe import MoEMlpBlock
from valor_tpu_torch.ops.masks import concat_key_mask, fusion_attention_bias_terms
from valor_tpu_torch.parallel.activations import gather_sequence, scatter_sequence, sequence_sharded
from valor_tpu_torch.parallel.pipeline import pipeline_layers

CROSS_ATTN_TYPES = ("va_concate", "va_parallel", "video_audio", "audio_video")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1  # hidden and attention dropout, in training mode only
    has_cross_attn: bool = False
    cross_attn_type: Optional[str] = None  # one of CROSS_ATTN_TYPES
    moe_experts: int = 0  # > 0: a top-k MoE FFN on every moe_every-th layer
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_every: int = 1  # 1 = every layer, 2 = every other
    cross_attn_kv_heads: int = 0  # > 0: grouped-query cross-attention K/V heads
    pipeline_stages: int = 0  # > 0: the layer stack pipelines over that many pipe ranks
    pipeline_interleave: int = 1  # V > 1: the interleaved schedule, V virtual stages a device


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        self.dtype = dtype
        self.word_embeddings = _param((c.vocab_size, c.hidden_size), device)
        self.position_embeddings = _param((c.max_position_embeddings, c.hidden_size), device)
        self.token_type_embeddings = _param((c.type_vocab_size, c.hidden_size), device)
        self.prompt_embedding = _param((1, c.hidden_size), device)
        self.LayerNorm = LayerNorm(c.hidden_size, 1e-12, dtype, device)
        self.dropout = c.dropout

    def forward(self, input_ids: torch.Tensor, token_type: Optional[str] = None,
                full_masker: bool = False) -> torch.Tensor:
        n = input_ids.shape[1]
        dev = input_ids.device
        position_ids = torch.arange(n, device=dev)
        if full_masker and token_type is None:
            half = n // 2
            position_ids = torch.cat([torch.arange(half, device=dev),
                                      torch.arange(half, device=dev) + 1])
        x = F.embedding(input_ids, self.word_embeddings)
        x = x + self.position_embeddings[position_ids][None]
        if token_type == "prompt":
            x = x + self.prompt_embedding[0]
        else:
            x = x + self.token_type_embeddings[0]
        return dropout(self.LayerNorm(x.to(self.dtype)), self.dropout, self.training)


class _ResidualAttn(nn.Module):
    """attention -> dense -> LN(residual): BertSelfOutput / BertCrossOutput."""

    def __init__(self, width: int, num_heads: int, dtype=torch.float32, device=None,
                 dropout: float = 0.0, kv_heads: int = 0):
        super().__init__()
        self.attn = MultiHeadAttention(width, num_heads, dtype, device, dropout, kv_heads)
        self.ln = LayerNorm(width, 1e-12, dtype, device)

    def forward(self, x, kv, bias=None, extra_kv=None, sequence=False):
        return self.ln(x + self.attn(x, kv, bias, extra_kv=extra_kv, sequence=sequence), sequence)

    def compute_kv(self, mem):
        return self.attn.compute_kv(mem)


class BertFusionLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None, layer_idx: int = 0):
        super().__init__()
        c = self.cfg = cfg
        self.dtype = dtype
        w, h = c.hidden_size, c.num_heads
        self.self_attn = _ResidualAttn(w, h, dtype, device, c.dropout)
        if c.has_cross_attn:
            if c.cross_attn_type not in CROSS_ATTN_TYPES:
                raise ValueError(f"unknown cross_attn_type {c.cross_attn_type!r}")
            kvh = c.cross_attn_kv_heads
            if kvh and h % kvh:
                raise ValueError(f"{h} heads not divisible by {kvh} kv heads")
            if c.cross_attn_type == "va_concate":
                self.cross_attn = _ResidualAttn(w, h, dtype, device, c.dropout, kvh)
            else:
                self.cross_attn_v = _ResidualAttn(w, h, dtype, device, c.dropout, kvh)
                self.cross_attn_a = _ResidualAttn(w, h, dtype, device, c.dropout, kvh)
        self.use_moe = c.moe_experts > 0 and layer_idx % c.moe_every == c.moe_every - 1
        if self.use_moe:
            self.moe_mlp = MoEMlpBlock(w, c.moe_experts, c.intermediate, c.moe_top_k,
                                       c.moe_capacity_factor, "gelu", dtype, device)
        else:
            self.mlp = MlpBlock(w, c.intermediate, "gelu", dtype, device)
        self.out_ln = LayerNorm(w, 1e-12, dtype, device)

    def compute_cross_kv(self, video_feat, audio_feat) -> dict:
        """Per-layer cross-attention K/V for the decode, projected once per rollout."""
        c = self.cfg
        out = {}
        if not c.has_cross_attn:
            return out
        if c.cross_attn_type == "va_concate":
            mem = [f for f in (video_feat, audio_feat) if f is not None]
            if mem:
                mem = torch.cat(mem, dim=1) if len(mem) > 1 else mem[0]
                out["cross_attn"] = self.cross_attn.compute_kv(mem.to(self.dtype))
        else:
            if video_feat is not None:
                out["cross_attn_v"] = self.cross_attn_v.compute_kv(video_feat.to(self.dtype))
            if audio_feat is not None:
                out["cross_attn_a"] = self.cross_attn_a.compute_kv(audio_feat.to(self.dtype))
        return out

    def forward(self, x, bias, video_feat, audio_feat, cross_kv: Optional[dict] = None,
                self_extra_kv=None, sequence: bool = False):
        """``self_extra_kv`` (k, v): cached keys and values that self-attention
        takes beside those of ``x`` (the context-K/V decode); ``sequence``:
        ``x`` is this model rank's chunk of the sequence, and so is the
        output."""
        c, sp = self.cfg, sequence
        x = self.self_attn(x, x, bias, extra_kv=self_extra_kv, sequence=sp)
        has_media = video_feat is not None or audio_feat is not None or bool(cross_kv)
        if c.has_cross_attn and has_media:
            t = c.cross_attn_type
            if cross_kv:
                if t == "va_concate":
                    x = self.cross_attn(x, None, extra_kv=cross_kv["cross_attn"], sequence=sp)
                elif t == "va_parallel":
                    parts = [
                        getattr(self, key)(x, None, extra_kv=cross_kv[key], sequence=sp)
                        for key in ("cross_attn_v", "cross_attn_a") if key in cross_kv
                    ]
                    x = sum(parts) if len(parts) > 1 else parts[0]
                else:
                    order = ("v", "a") if t == "video_audio" else ("a", "v")
                    for mod in order:
                        key = f"cross_attn_{mod}"
                        if key in cross_kv:
                            x = getattr(self, key)(x, None, extra_kv=cross_kv[key], sequence=sp)
            elif t == "va_concate":
                mem = [f for f in (video_feat, audio_feat) if f is not None]
                mem = torch.cat(mem, dim=1) if len(mem) > 1 else mem[0]
                x = self.cross_attn(x, mem, sequence=sp)
            elif t == "va_parallel":
                if video_feat is not None and audio_feat is not None:
                    x = self.cross_attn_v(x, video_feat, sequence=sp) + self.cross_attn_a(x, audio_feat, sequence=sp)
                elif video_feat is not None:
                    x = self.cross_attn_v(x, video_feat, sequence=sp)
                else:
                    x = self.cross_attn_a(x, audio_feat, sequence=sp)
            else:
                order = ("v", "a") if t == "video_audio" else ("a", "v")
                for mod in order:
                    feat = video_feat if mod == "v" else audio_feat
                    if feat is not None:
                        x = getattr(self, f"cross_attn_{mod}")(x, feat, sequence=sp)
        if self.use_moe:
            h, aux = self.moe_mlp(x, sequence=sp)
            sow(aux)
        else:
            h = self.mlp(x, sequence=sp)
        return self.out_ln(x + dropout(h, c.dropout, self.training, sequence=sp), sp)


class BertFusionEncoder(nn.Module):
    """Embeddings + mask construction + N fusion layers; ``remat`` checkpoints
    each layer in the backward (``ops.layers.run_layer``)."""

    def __init__(self, cfg: BertConfig, dtype=torch.float32, device=None, remat: bool = False):
        super().__init__()
        c = cfg
        if c.pipeline_stages > 0 and c.moe_experts > 0:
            # MoE capacity is claimed batch-wide, so microbatches would route differently
            raise ValueError("pipeline_stages and moe_experts are mutually exclusive")
        if c.pipeline_stages > 0 and c.num_layers % (c.pipeline_stages * max(c.pipeline_interleave, 1)):
            raise ValueError(
                f"{c.num_layers} fusion layers do not divide into {c.pipeline_stages} pipeline stages"
                + (f" x {c.pipeline_interleave} interleaved chunks" if c.pipeline_interleave > 1 else "")
            )
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.embeddings = BertEmbeddings(cfg, dtype, device)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertFusionLayer(cfg, dtype, device, i))

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def embedding_table(self) -> torch.Tensor:
        """Word-embedding table for tied-weight decoding."""
        return self.embeddings.word_embeddings

    def precompute_cross_kv(self, video_feat, audio_feat) -> list:
        """Per-layer cross-attention K/V for the decode fast path."""
        return [layer.compute_cross_kv(video_feat, audio_feat) for layer in self.layers]

    def precompute_ctx_kv(self, task_prompt, video_feat, audio_feat):
        """Self-attention K/V of the [prompt | video | audio] context, per layer,
        for the decode without cross-attention (media in the sequence).

        Under the causal-prefix mask (``ops/masks.py``) no context position
        attends to the text, so the context's hidden states do not depend on
        the text: the stack run on the context alone gives them exactly, and
        every decode step reuses their K/V.  Returns (kv_list, ctx_mask [B, Nc])."""
        feats, masks = [], []
        if task_prompt is not None:
            feats.append(self.embeddings(task_prompt, "prompt"))
            masks.append((task_prompt != 0).float())
        for f in (video_feat, audio_feat):
            if f is not None:
                feats.append(f.to(self.dtype))
                masks.append(torch.ones(f.shape[:2], device=f.device))
        x = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
        ctx_mask = torch.cat(masks, dim=1) if len(masks) > 1 else masks[0]
        bias = ((1.0 - ctx_mask) * -1e4)[:, None, None, :]
        kv_list = []
        for layer in self.layers:
            kv_list.append(layer.self_attn.compute_kv(x))
            x = layer(x, bias, None, None)
        return kv_list, ctx_mask

    def decode_with_ctx(self, tokens: torch.Tensor, token_mask: torch.Tensor, ctx_kv_list: list,
                        ctx_mask: torch.Tensor) -> torch.Tensor:
        """The text buffer [B, N] through the stack, each layer's
        self-attention taking the cached context K/V as extra keys: causal over
        the text (and ``token_mask``), the whole valid context for every query."""
        x = self.embeddings(tokens, None, False)
        b, n = tokens.shape
        nc = ctx_mask.shape[1]
        idx = torch.arange(n, device=tokens.device)
        causal = (idx[None, :] <= idx[:, None]).float()[None]  # [1, N, N]
        text_part = causal * token_mask.float()[:, None, :]
        ctx_part = ctx_mask[:, None, :].expand(b, n, nc)
        mask = torch.cat([text_part, ctx_part], dim=-1)
        bias = ((1.0 - mask) * -1e4)[:, None]
        for layer, kv in zip(self.layers, ctx_kv_list):
            x = layer(x, bias, None, None, self_extra_kv=kv)
        return x

    def forward(
        self,
        tokens: Optional[torch.Tensor],  # [B, N] int or None
        task_prompt: Optional[torch.Tensor] = None,  # [B, P] int
        video_feat: Optional[torch.Tensor] = None,  # [B, Nv, C]
        audio_feat: Optional[torch.Tensor] = None,  # [B, Na, C]
        causal: bool = False,
        full_masker: bool = False,
        token_mask: Optional[torch.Tensor] = None,  # overrides (tokens != 0)
        cross_kv_list: Optional[list] = None,  # per-layer decode K/V cache
    ) -> torch.Tensor:
        c = self.cfg
        feats = []
        text_mask = None
        text_len = 0
        if tokens is not None:
            feats.append(self.embeddings(tokens, None, full_masker))
            text_mask = token_mask.float() if token_mask is not None else (tokens != 0).float()
            text_len = tokens.shape[1]
        prompt_mask = None
        if task_prompt is not None:
            feats.append(self.embeddings(task_prompt, "prompt"))
            prompt_mask = (task_prompt != 0).float()

        # video/audio join the token sequence only when cross-attention is off
        in_seq_video = video_feat if not c.has_cross_attn else None
        in_seq_audio = audio_feat if not c.has_cross_attn else None
        n_video = in_seq_video.shape[1] if in_seq_video is not None else 0
        n_audio = in_seq_audio.shape[1] if in_seq_audio is not None else 0
        if in_seq_video is not None:
            feats.append(in_seq_video.to(self.dtype))
        if in_seq_audio is not None:
            feats.append(in_seq_audio.to(self.dtype))

        x = torch.cat(feats, dim=1) if len(feats) > 1 else feats[0]
        key_mask = concat_key_mask(text_mask, prompt_mask, n_video, n_audio, x.shape[0], x.device)
        bias = fusion_attention_bias_terms(key_mask, text_len, causal, full_masker)

        cross_v = video_feat.to(self.dtype) if (c.has_cross_attn and video_feat is not None) else None
        cross_a = audio_feat.to(self.dtype) if (c.has_cross_attn and audio_feat is not None) else None
        if cross_kv_list is None:
            pipelined = self._maybe_pipeline(x, bias, cross_v, cross_a)
            if pipelined is not None:
                return pipelined
        sp = sequence_sharded(x)
        if sp:
            x = scatter_sequence(x, partial=False)
        for i, layer in enumerate(self.layers):
            kv = cross_kv_list[i] if cross_kv_list is not None else None
            x = run_layer(layer, self.remat, x, bias, cross_v, cross_a, kv, None, sp)
        return gather_sequence(x, partial=False) if sp else x

    def _maybe_pipeline(self, x, bias, cross_v, cross_a) -> Optional[torch.Tensor]:
        """The layer stack through ``parallel/pipeline.py:pipeline_layers``
        where the config has stages and the pipeline engages; None: the plain
        stack (sequence parallelism stays off on the pipelined path, as the
        JAX package returns before ``sequence_sharded``)."""
        c = self.cfg
        if c.pipeline_stages <= 0:
            return None
        return pipeline_layers(self.layers, self.remat, x, bias, cross_v, cross_a, c.pipeline_stages,
                               max(c.pipeline_interleave, 1))


class BertPredictionHead(nn.Module):
    """dense -> gelu -> LN -> tied-embedding decode (+ bias).  The decoder
    weight is the fusion encoder's word table, passed in by the caller."""

    def __init__(self, hidden: int, vocab: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = Dense(hidden, hidden, dtype=dtype, device=device)
        self.layernorm = LayerNorm(hidden, 1e-12, dtype, device)
        self.decoder_bias = _param((vocab,), device)

    def forward(self, x: torch.Tensor, embedding_table: torch.Tensor) -> torch.Tensor:
        h = self.layernorm(F.gelu(self.dense(x)))
        logits = torch.matmul(h, embedding_table.t().to(h.dtype))
        return logits + self.decoder_bias.to(logits.dtype)
