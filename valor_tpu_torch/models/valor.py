"""VALOR model (counterpart of ``valor_tpu/models/valor.py``).

Builds the video tower (CLIP vision, or VideoSwin), the CLIP text tower where
either tower is CLIP (from the CLIP video preset, else from the text one) and,
with a CLIP video tower, the CLIP projections (beside a VideoSwin tower the JAX
package creates no CLIP vision or projection parameters), the AST audio tower,
the BERT fusion encoder (with MoE FFNs and grouped-query cross-attention where
the config asks) and its prediction head, the contrastive heads and
fine-grained token weights, the adapters and the frame and type embeddings.
Caption generation calls ``encode_video``, ``encode_audio``,
``video_fusion_input``, ``audio_fusion_input``, ``fusion_logits`` and
``fusion_cross_kv`` (or, without cross-attention, ``fusion_ctx_kv`` and
``fusion_logits_ctx``); training calls the model on a batch and a task
(``forward_pt``: the contrastive, caption and MLM losses; ``forward_ret``: the
contrastive loss of the retrieval groups, or with ``compute_loss=False`` the
features that retrieval evaluation scores).  A batch may carry clip-span
waveforms (``audio_waveforms`` [B, n_clips, L] with ``audio_valid_frames``
[B, n_clips]) in place of spectrograms: the forward turns them into
normalised log-mel clips on the device (``data/fbank.py:fbank_clips_from_spans``)
in the model's dtype.  ``forward_cap`` gives the caption loss over the task's
groups; ``forward_qa`` the answer loss of the QA collate's tiled rows
(``tile_index`` maps each answer row to its question's media row,
``answer_weights`` weighs the rows, normalised by the question count).

Batch convention: video_pixels [B, n_frames, H, W, 3] (float, or raw uint8
normalised here with CLIP's statistics for a CLIP video tower and ImageNet's
otherwise), audio_spectrograms [B, n_clips, melbins, target_length],
bert_tokens / clip_tokens [B, N] with pad id 0.  Token masking draws from the
"mask" stream and dropout from the "dropout" stream of the enclosing
``ops.layers.rng_scope``; dropout runs in training mode only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from valor_tpu_torch.core.config import ModelConfig
from valor_tpu_torch.core.device import resolve_device, torch_dtype
from valor_tpu_torch.core.tasks import TaskSpec
from valor_tpu_torch.data.fbank import fbank_clips_from_spans
from valor_tpu_torch.data.pipeline import CLIP_MEAN, CLIP_STD, IMAGENET_MEAN, IMAGENET_STD
from valor_tpu_torch.models.ast import ASTConfig, ASTEncoder
from valor_tpu_torch.models.bert import BertConfig, BertFusionEncoder, BertPredictionHead
from valor_tpu_torch.models.clip import (
    CLIPProjections, CLIPTextTransformer, CLIPVisionTransformer, text_preset, vision_preset,
)
from valor_tpu_torch.models.videoswin import SwinTransformer3D, swin_preset
from valor_tpu_torch.ops.layers import Dense, LayerNorm, _param, current_rng, remat_for
from valor_tpu_torch.ops.masking import full_mask, lm_shift_labels, mask_tokens
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel.mesh import answer_shard, batch_rank, batch_shard, collective_step, current_shard
from valor_tpu_torch.tasks import losses as L

# BERT special tokens (bert-base-uncased vocab)
BOS_TOKEN = 101  # [CLS]
EOS_TOKEN = 102  # [SEP]
MASK_TOKEN = 103  # [MASK]
MASK_RANGE_START = 106  # start of the random-replacement range

MAX_FRAMES = 32  # frame/clip embedding rows


def answer_rows(n: int):
    """The shard of a QA step's ``n`` tiled answer rows: in a training step
    across ranks (whose answer counts differ), every rank's rows concatenated
    in rank order; elsewhere the enclosing shard."""
    if not collective_step():
        return current_shard()
    return answer_shard(n, C.all_gather_objects(n))


def bcast_prompt(prompt: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
    """Broadcast a [1, P] task prompt to the batch."""
    if prompt is None or prompt.shape[0] == batch:
        return prompt
    return prompt.expand((batch,) + tuple(prompt.shape[1:]))


class FineWeight(nn.Module):
    """Per-token weight MLP: dense -> relu -> dense(1)."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(dim, dim, dtype=dtype, device=device)
        self.fc2 = Dense(dim, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))[..., 0]


class VALORModel(nn.Module):
    """Parameters are allocated on ``device`` (the CUDA card when None) and
    left uninitialised: load them with ``models.bridge``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dev = resolve_device(device)
        dtype = self.dtype = torch_dtype(c.dtype)
        if not c.audio_encoder_type.startswith("ast"):
            raise NotImplementedError(f"audio_encoder_type {c.audio_encoder_type!r} (only 'ast')")

        def remat(which: str) -> bool:
            return remat_for(c.checkpointing, c.remat_scope, which)

        self.is_clip_video = c.video_encoder_type.startswith("clip")
        self.is_clip_text = c.txt_encoder_type.startswith("clip")
        self.is_videoswin = c.video_encoder_type.startswith("videoswin")
        if not (self.is_clip_video or self.is_videoswin):
            raise ValueError(f"unknown video_encoder_type {c.video_encoder_type!r}")
        if self.is_clip_video or self.is_clip_text:
            clip_name = c.video_encoder_type if self.is_clip_video else c.txt_encoder_type
            vp = vision_preset(clip_name, c.video_resolution)
            tp = text_preset(clip_name)
            if c.clip_vision_layers:
                vp = dataclasses.replace(vp, layers=c.clip_vision_layers)
            if c.clip_text_layers:
                tp = dataclasses.replace(tp, layers=c.clip_text_layers)
            if self.is_clip_video:
                self.clip_vision = CLIPVisionTransformer(vp, dtype, dev, remat("vision"))
                self.clip_proj = CLIPProjections(vp.width, tp.width, tp.embed_dim, dev)
            self.clip_text = CLIPTextTransformer(tp, dtype, dev, remat("text"))
            self.video_dim = vp.width
            self.txt_dim = tp.width
        if self.is_videoswin:
            self.video_encoder = SwinTransformer3D(swin_preset(c.video_encoder_type), dtype, dev,
                                                   remat("vision"))
            self.video_dim = self.video_encoder.cfg.num_features

        ast_cfg = ASTConfig(
            hidden_size=c.audio_hidden, layers=c.audio_layers, heads=c.audio_heads,
            intermediate=c.audio_intermediate, melbins=c.audio_melbins,
            target_length=c.audio_target_length, patch_size=c.audio_patch_size,
            dropout=c.dropout,
        )
        self.audio_encoder = ASTEncoder(ast_cfg, dtype, dev, remat("audio"))
        self.audio_dim = ast_cfg.hidden_size

        self.bert_cfg = BertConfig(
            vocab_size=c.fusion_vocab, hidden_size=c.fusion_hidden,
            num_layers=c.fusion_layers, num_heads=c.fusion_heads,
            intermediate=c.fusion_intermediate, dropout=c.dropout,
            has_cross_attn=c.multimodal_use_cross_attn,
            cross_attn_type=c.cross_attn_type if c.multimodal_use_cross_attn else None,
            moe_experts=c.fusion_moe_experts, moe_top_k=c.fusion_moe_top_k,
            moe_every=c.fusion_moe_every, moe_capacity_factor=c.fusion_moe_capacity_factor,
            cross_attn_kv_heads=c.fusion_cross_attn_kv_heads,
            pipeline_stages=c.fusion_pipeline_stages, pipeline_interleave=c.fusion_pipeline_interleave,
        )
        self.multimodal_encoder = BertFusionEncoder(self.bert_cfg, dtype, dev, remat("fusion"))
        h = self.multimodal_dim = c.fusion_hidden
        self.cls_head = BertPredictionHead(h, c.fusion_vocab, dtype, dev)

        # text encoder of the contrastive objective: the CLIP text tower, or a
        # dense BERT without cross-attention (the fusion encoder itself when shared)
        if not self.is_clip_text:
            self.txt_dim = h
            if not c.share_txt_and_multimodal:
                self.txt_encoder = BertFusionEncoder(
                    dataclasses.replace(self.bert_cfg, has_cross_attn=False, cross_attn_type=None,
                                        moe_experts=0),
                    dtype, dev, remat("text"))

        # contrastive heads: CLIP's projections only where both towers are CLIP
        self.use_clip_head = self.is_clip_video and self.is_clip_text and c.init_clip_head
        if self.use_clip_head:
            contra_dim = tp.embed_dim
        else:
            contra_dim = c.contra_dim
            self.contra_head_t = Dense(self.txt_dim, contra_dim, use_bias=False, dtype=dtype, device=dev)
            self.contra_head_v = Dense(self.video_dim, contra_dim, use_bias=False, dtype=dtype, device=dev)
        self.contra_dim = contra_dim
        self.contra_head_a = Dense(self.audio_dim, contra_dim, use_bias=False, dtype=dtype, device=dev)
        if c.contra_type == "coarse" and not c.late_fusion:
            self.va_fusion = Dense(2 * contra_dim, contra_dim, dtype=dtype, device=dev)
        if c.contra_type == "fine":
            self.text_fine_weight = FineWeight(contra_dim, dtype, dev)
            self.video_fine_weight = FineWeight(contra_dim, dtype, dev)
            self.audio_fine_weight = FineWeight(contra_dim, dtype, dev)
        self.contra_temp = _param((), dev)

        self.video_type_embeddings = _param((1, 1, h), dev)
        self.audio_type_embeddings = _param((1, 1, h), dev)
        self.video_frame_embedding = _param((1, MAX_FRAMES, h), dev)
        self.audio_frame_embedding = _param((1, MAX_FRAMES, h), dev)
        if self.video_dim != h:
            self.video_adapter = Dense(self.video_dim, h, dtype=dtype, device=dev)
            self.video_adapter_ln = LayerNorm(h, 1e-12, dtype, dev)
        if self.audio_dim != h:
            self.audio_adapter = Dense(self.audio_dim, h, dtype=dtype, device=dev)
            self.audio_adapter_ln = LayerNorm(h, 1e-12, dtype, dev)
        stats = (CLIP_MEAN, CLIP_STD) if self.is_clip_video else (IMAGENET_MEAN, IMAGENET_STD)
        self.register_buffer("pixel_stats", torch.tensor(np.stack(stats), device=dev),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.video_type_embeddings.device

    @property
    def text_encoder(self) -> nn.Module:
        """The contrastive objective's text tower."""
        if self.is_clip_text:
            return self.clip_text
        return self.multimodal_encoder if self.cfg.share_txt_and_multimodal else self.txt_encoder

    # -- encoders ----------------------------------------------------------
    def encode_video(self, video_pixels: torch.Tensor) -> torch.Tensor:
        """[B, n, H, W, 3] -> [B, n, 1 + g*g, C] (CLIP: every frame's tokens)
        or [B, D', H'W', C] (VideoSwin: the feature volume's time steps).  Raw
        uint8 pixels are normalised here, (x/255 - mean)/std in fp32, then cast."""
        if video_pixels.dtype == torch.uint8:
            mean, std = self.pixel_stats
            video_pixels = ((video_pixels.float() / 255.0 - mean) / std).to(self.dtype)
        if self.is_videoswin:
            out = self.video_encoder(video_pixels)
            bb, d, hh, ww, cc = out.shape
            return out.reshape(bb, d, hh * ww, cc)
        b, n = video_pixels.shape[:2]
        out = self.clip_vision(video_pixels.reshape((b * n,) + tuple(video_pixels.shape[2:])))
        return out.reshape(b, n, out.shape[1], out.shape[2])

    def encode_audio(self, spectrograms: torch.Tensor) -> torch.Tensor:
        """[B, n, mel, len] -> [B, n, 1 + tokens, C]."""
        b, n = spectrograms.shape[:2]
        out = self.audio_encoder(spectrograms.reshape((b * n,) + tuple(spectrograms.shape[2:])))
        return out.reshape(b, n, out.shape[1], out.shape[2])

    def encode_text(self, tokens: torch.Tensor,
                    task_prompt: Optional[torch.Tensor] = None) -> torch.Tensor:
        task_prompt = bcast_prompt(task_prompt, tokens.shape[0])
        if self.is_clip_text:
            out = self.clip_text(tokens, task_prompt, causal=True)
        else:
            out = self.text_encoder(tokens, task_prompt=task_prompt, causal=False)
        if task_prompt is not None:
            out = out[:, : tokens.shape[1]]
        return out

    # -- pooling -------------------------------------------------------------
    def pool_text(self, feature, tokens, contra_type=None):
        if (contra_type or self.cfg.contra_type) == "coarse":
            if self.is_clip_text:  # the EOT token: CLIP's largest id
                idx = torch.argmax(tokens, dim=-1)
                return feature[torch.arange(tokens.shape[0], device=feature.device), idx]
            return feature[:, 0]
        return feature

    def pool_video(self, feature, contra_type=None):
        feature = feature.mean(2) if self.is_videoswin else feature[:, :, 0]
        return feature.mean(1) if (contra_type or self.cfg.contra_type) == "coarse" else feature

    def pool_audio(self, feature, contra_type=None):
        feature = feature[:, :, 0]
        return feature.mean(1) if (contra_type or self.cfg.contra_type) == "coarse" else feature

    # -- fusion-space inputs -----------------------------------------------
    def video_fusion_input(self, video_output: torch.Tensor) -> torch.Tensor:
        b, n, x, _ = video_output.shape
        v = video_output
        if self.video_dim != self.multimodal_dim:
            v = self.video_adapter_ln(self.video_adapter(v))
        v = v + self.video_frame_embedding[:, :n, None, :].to(v.dtype)
        v = v.reshape(b, n * x, self.multimodal_dim)
        return v + self.video_type_embeddings.to(v.dtype)

    def audio_fusion_input(self, audio_output: torch.Tensor) -> torch.Tensor:
        b, n, x, _ = audio_output.shape
        a = audio_output
        if self.audio_dim != self.multimodal_dim:
            a = self.audio_adapter_ln(self.audio_adapter(a))
        a = a + self.audio_frame_embedding[:, :n, None, :].to(a.dtype)
        a = a.reshape(b, n * x, self.multimodal_dim)
        return a + self.audio_type_embeddings.to(a.dtype)

    # -- fusion decoding ---------------------------------------------------
    def fusion_logits(
        self,
        txt_tokens: torch.Tensor,
        prompt_tokens: Optional[torch.Tensor],
        video_input: Optional[torch.Tensor],
        audio_input: Optional[torch.Tensor],
        causal: bool,
        full_masker: bool = False,
        token_mask: Optional[torch.Tensor] = None,
        cross_kv_list: Optional[list] = None,
    ) -> torch.Tensor:
        """Run the fusion encoder and score every text position. [B, N, V]."""
        prompt_tokens = bcast_prompt(prompt_tokens, txt_tokens.shape[0])
        out = self.multimodal_encoder(
            txt_tokens, task_prompt=prompt_tokens, video_feat=video_input,
            audio_feat=audio_input, causal=causal, full_masker=full_masker,
            token_mask=token_mask, cross_kv_list=cross_kv_list,
        )
        text_out = out[:, : txt_tokens.shape[1]]
        return self.cls_head(text_out, self.multimodal_encoder.embedding_table())

    def fusion_cross_kv(self, video_input, audio_input) -> list:
        """Per-layer cross-attention K/V for decoding."""
        return self.multimodal_encoder.precompute_cross_kv(video_input, audio_input)

    def fusion_ctx_kv(self, prompt_tokens, video_input, audio_input):
        """The [prompt | media] context's per-layer self-attention K/V and its
        mask, for decoding with the media in the sequence
        (``multimodal_use_cross_attn=False``)."""
        media = video_input if video_input is not None else audio_input
        if media is not None:
            prompt_tokens = bcast_prompt(prompt_tokens, media.shape[0])
        return self.multimodal_encoder.precompute_ctx_kv(prompt_tokens, video_input, audio_input)

    def fusion_logits_ctx(self, tokens, token_mask, ctx_kv_list, ctx_mask) -> torch.Tensor:
        """Score every text position, attending to the cached context. [B, N, V]."""
        out = self.multimodal_encoder.decode_with_ctx(tokens, token_mask, ctx_kv_list, ctx_mask)
        return self.cls_head(out, self.multimodal_encoder.embedding_table())

    # -- contrastive features and losses ---------------------------------------
    def project_text(self, pooled):
        return self.clip_proj.project_text(pooled) if self.use_clip_head else self.contra_head_t(pooled)

    def project_video(self, pooled):
        return self.clip_proj.project_visual(pooled) if self.use_clip_head else self.contra_head_v(pooled)

    def temperature(self) -> torch.Tensor:
        """CLIP's learned logit scale with a CLIP video tower, otherwise the
        learned scalar ``contra_temp``."""
        return self.clip_proj.temperature() if self.is_clip_video else self.contra_temp

    def contra_features(self, txt_tokens, video_output, audio_output,
                        prompt_tokens=None) -> Dict[str, Any]:
        """Pooled, projected, L2-normalised per-modality features."""
        out: Dict[str, Any] = {"feat_t": None, "feat_v": None, "feat_a": None,
                               "txt_tokens": txt_tokens}
        if txt_tokens is not None:
            pooled = self.pool_text(self.encode_text(txt_tokens, prompt_tokens), txt_tokens)
            out["feat_t"] = L.l2_normalize(self.project_text(pooled))
        if video_output is not None:
            out["feat_v"] = L.l2_normalize(self.project_video(self.pool_video(video_output)))
        if audio_output is not None:
            out["feat_a"] = L.l2_normalize(self.contra_head_a(self.pool_audio(audio_output)))
        return out

    def _fine_parts(self, feats, txt_tokens):
        parts = {}
        if feats["feat_t"] is not None:
            ft = feats["feat_t"]
            parts["t"] = (ft, (txt_tokens != 0).float(), self.text_fine_weight(ft))
        for k, mod in (("v", self.video_fine_weight), ("a", self.audio_fine_weight)):
            f = feats[f"feat_{k}"]
            if f is not None:
                parts[k] = (f, torch.ones(f.shape[:2], device=f.device), mod(f))
        return parts

    def group_score_matrix(self, group: str, feats: Dict[str, Any], txt_tokens,
                           gallery: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """Score matrix of one modality group ('tv', 'ta', 'tva', 'va', 'vta',
        'atv'): its rows from ``feats``, its columns from ``gallery`` (features
        with their ``txt_tokens``; ``feats`` where None)."""
        c = self.cfg
        if c.contra_type == "coarse":
            cols = feats if gallery is None else gallery
            ft, fv, fa = feats["feat_t"], cols["feat_v"], cols["feat_a"]
            if group == "tv":
                return L.coarse_score(ft, fv)
            if group == "ta":
                return L.coarse_score(ft, fa)
            if group == "tva":
                if c.late_fusion:
                    return L.coarse_score(ft, fv) + L.coarse_score(ft, fa)
                return L.coarse_score(ft, L.l2_normalize(self.va_fusion(torch.cat([fv, fa], -1))))
            raise ValueError(f"coarse contra does not support group {group!r}")

        parts = self._fine_parts(feats, txt_tokens)
        columns = parts if gallery is None else self._fine_parts(gallery, gallery["txt_tokens"])

        def cat(keys):
            return tuple(torch.cat([columns[k][i] for k in keys], dim=1) for i in range(3))

        if group == "tva" and c.late_fusion:
            t, v, a = parts["t"], columns["v"], columns["a"]
            ones = lambda p: torch.ones_like(p[2])  # noqa: E731
            return (L.fine_score(t[0], v[0], t[1], v[1], ones(t), ones(v))
                    + L.fine_score(t[0], a[0], t[1], a[1], ones(t), ones(a)))
        pairs = {"tv": ("t", "v"), "ta": ("t", "a"), "va": ("v", "a"),
                 "tva": ("t", "va"), "vta": ("v", "ta"), "atv": ("a", "tv")}
        if group not in pairs:
            raise ValueError(group)
        ka, kb = pairs[group]
        a = parts[ka]
        b = columns[kb] if len(kb) == 1 else cat(kb)
        if group == "tva" and c.fineweight_type == "none":
            a = (a[0], a[1], torch.ones_like(a[2]))
            b = (b[0], b[1], torch.ones_like(b[2]))
        return L.fine_score(a[0], b[0], a[1], b[1], a[2], b[2])

    def contra_loss_over_groups(self, groups, feats, txt_tokens) -> torch.Tensor:
        """The contrastive loss averaged over ``groups``.  In a training step
        across ranks the score matrix is the global batch's, as the JAX
        package's: every rank gathers the batch's features
        (``all_gather_with_grad``) and scores its own rows and columns
        against them (``sharded_contrastive_loss``)."""
        temp = self.temperature()
        if not collective_step():
            ls = [L.contrastive_loss(self.group_score_matrix(g, feats, txt_tokens), temp)
                  for g in groups]
            return sum(ls) / len(ls)
        local = dict(feats, txt_tokens=txt_tokens)
        every = {k: None if v is None else C.all_gather_with_grad(v) for k, v in local.items()}
        offset = batch_rank() * next(v.shape[0] for v in local.values() if v is not None)
        ls = [L.sharded_contrastive_loss(self.group_score_matrix(g, local, txt_tokens, every),
                                         self.group_score_matrix(g, every, every["txt_tokens"], local),
                                         temp, offset) for g in groups]
        return sum(ls) / len(ls)

    # -- caption and MLM inputs ------------------------------------------------
    def caption_inputs(self, txt_tokens: torch.Tensor, train: bool = True):
        """(input tokens, labels) of the caption objective."""
        c = self.cfg
        if c.caption_type == "unimlm":
            if c.full_masker:
                return full_mask(txt_tokens, MASK_TOKEN)
            gen = current_rng("token masking").generator(txt_tokens.device, "mask")
            return mask_tokens(gen, txt_tokens, 0.6, MASK_TOKEN, MASK_RANGE_START, c.fusion_vocab)
        return txt_tokens, lm_shift_labels(txt_tokens)

    def group_caption_loss(self, group, txt_input, txt_labels, prompt_tokens,
                           video_input, audio_input) -> torch.Tensor:
        logits = self.fusion_logits(txt_input, prompt_tokens,
                                    video_input if "v" in group else None,
                                    audio_input if "a" in group else None,
                                    True, self.cfg.full_masker)
        return L.masked_cross_entropy(logits, txt_labels, self.cfg.label_smoothing)

    def _fusion_inputs(self, batch, groups):
        """The fusion-space media inputs of the groups' modalities (None where unused)."""
        video_input = audio_input = None
        if any("v" in g for g in groups):
            video_input = self.video_fusion_input(self.encode_video(batch["video_pixels"]))
        if any("a" in g for g in groups):
            audio_input = self.audio_fusion_input(self.encode_audio(batch["audio_spectrograms"]))
        return video_input, audio_input

    # -- task forwards ---------------------------------------------------------
    def forward(self, batch: Dict[str, Any], task: TaskSpec, compute_loss: bool = True,
                train: bool = True):
        """The losses (or features) of ``task`` on ``batch``, a dict of tensors
        on the model's device.  Dropout follows ``self.training``."""
        if batch.get("audio_waveforms") is not None:
            # the device fbank: the host ships clip-span waveforms
            # (AudioMapper device_fbank=True; data/fbank.py)
            batch = dict(batch)
            batch["audio_spectrograms"] = fbank_clips_from_spans(
                batch.pop("audio_waveforms"),
                batch.pop("audio_valid_frames"),
                melbins=self.cfg.audio_melbins,
                target_length=self.cfg.audio_target_length,
            ).to(self.dtype)
        if task.family == "pt":
            return self.forward_pt(batch, task, compute_loss, train)
        if task.family == "ret":
            return self.forward_ret(batch, task, compute_loss)
        if task.family == "cap":
            return self.forward_cap(batch, task, compute_loss, train)
        if task.family == "qa":
            return self.forward_qa(batch, task, compute_loss, train)
        raise ValueError(task.family)

    def _text_for(self, batch, encoder_type):
        return batch.get("clip_tokens" if encoder_type.startswith("clip") else "bert_tokens")

    def forward_pt(self, batch, task: TaskSpec, compute_loss: bool = True, train: bool = True):
        c = self.cfg
        video_output = self.encode_video(batch["video_pixels"]) if task.uses_video else None
        audio_output = (self.encode_audio(batch["audio_spectrograms"])
                        if task.uses_audio else None)
        out: Dict[str, Any] = {}

        if task.contra_groups:
            txt_contra = self._text_for(batch, c.txt_encoder_type)
            feats = self.contra_features(txt_contra, video_output, audio_output,
                                         batch.get("prompt_tokens_contra"))
            if compute_loss:
                out["contra_loss"] = (self.contra_loss_over_groups(
                    task.contra_groups, feats, txt_contra) * c.contra_loss_ratio)
            else:
                out.update(feats)

        txt_tokens = self._text_for(batch, c.multimodal_encoder_type)
        video_input = self.video_fusion_input(video_output) if video_output is not None else None
        audio_input = self.audio_fusion_input(audio_output) if audio_output is not None else None

        def group_logits(g, tokens, prompt, causal, full_masker=False):
            return self.fusion_logits(tokens, prompt, video_input if "v" in g else None,
                                      audio_input if "a" in g else None, causal, full_masker)

        if task.caption_groups:
            txt_input, txt_labels = self.caption_inputs(txt_tokens, train)
            ls = []
            for g in task.caption_groups:
                logits = group_logits(g, txt_input, batch.get("prompt_tokens_caption"), True,
                                      c.full_masker)
                if compute_loss:
                    ls.append(L.masked_cross_entropy(logits, txt_labels, c.label_smoothing))
                else:
                    out[f"caption_scores_{g}"] = logits
            if compute_loss:
                out["caption_loss"] = sum(ls) / len(ls)
            else:
                out["txt_labels_caption"] = txt_labels

        if task.mlm_groups:
            gen = current_rng("token masking").generator(txt_tokens.device, "mask")
            txt_input, txt_labels = mask_tokens(gen, txt_tokens, 0.15, MASK_TOKEN,
                                                MASK_RANGE_START, c.fusion_vocab)
            ls = []
            for g in task.mlm_groups:
                prompt = batch.get(f"prompt_tokens_mlm_{g}")
                if prompt is None:
                    prompt = batch.get("prompt_tokens_mlm")
                logits = group_logits(g, txt_input, prompt, False)
                if compute_loss:
                    ls.append(L.masked_cross_entropy(logits, txt_labels))
                else:
                    out[f"mlm_scores_{g}"] = logits
            if compute_loss:
                out["mlm_loss"] = sum(ls) / len(ls)
            else:
                out["txt_labels_mlm"] = txt_labels
        return out

    def forward_ret(self, batch, task: TaskSpec, compute_loss: bool = True):
        """The in-batch contrastive loss over the task's groups, or (with
        ``compute_loss=False``) the contrastive features and text tokens."""
        groups = task.contra_groups
        txt_tokens = (self._text_for(batch, self.cfg.txt_encoder_type)
                      if any("t" in g for g in groups) else None)
        video_output = (self.encode_video(batch["video_pixels"])
                        if any("v" in g for g in groups) else None)
        audio_output = (self.encode_audio(batch["audio_spectrograms"])
                        if any("a" in g for g in groups) else None)
        feats = self.contra_features(txt_tokens, video_output, audio_output,
                                     batch.get("prompt_tokens_contra"))
        if not compute_loss:
            return feats
        return {"contra_loss": self.contra_loss_over_groups(groups, feats, txt_tokens)}

    def forward_cap(self, batch, task: TaskSpec, compute_loss: bool = True, train: bool = True):
        """The caption loss averaged over the task's groups, or (with
        ``compute_loss=False``) the fusion-space media inputs."""
        groups = task.caption_groups
        txt_tokens = self._text_for(batch, self.cfg.multimodal_encoder_type)
        video_input, audio_input = self._fusion_inputs(batch, groups)
        if not compute_loss:
            return {"video_input": video_input, "audio_input": audio_input}
        txt_input, txt_labels = self.caption_inputs(txt_tokens, train)
        ls = [self.group_caption_loss(g, txt_input, txt_labels, batch.get("prompt_tokens_caption"),
                                      video_input, audio_input) for g in groups]
        return {"caption_loss": sum(ls) / len(ls)}

    def forward_qa(self, batch, task: TaskSpec, compute_loss: bool = True, train: bool = True):
        """The generative QA loss.  Batch (``data/vqa.py`` collates):
        ``bert_tokens`` [Bt, N] answer rows, ``question_prompt`` [Bt, P],
        media with one row per question [Q, ...], ``tile_index`` [Bt] (row ->
        question; absent when Bt == Q) and ``answer_weights`` [Bt] (absent for
        single answers).  Answers are masked at 0.99 under unimlm."""
        c = self.cfg
        groups = task.caption_groups
        txt_tokens = self._text_for(batch, c.multimodal_encoder_type)
        prompt = batch.get("question_prompt")
        video_input, audio_input = self._fusion_inputs(batch, groups)
        tile = batch.get("tile_index")
        if tile is not None:
            tile = tile.long()
            video_input = video_input[tile] if video_input is not None else None
            audio_input = audio_input[tile] if audio_input is not None else None
        if not compute_loss:
            return {"video_input": video_input, "audio_input": audio_input, "prompt": prompt}

        with batch_shard(answer_rows(txt_tokens.shape[0])):
            if c.caption_type == "unimlm":
                if c.full_masker:
                    txt_input, labels = full_mask(txt_tokens, MASK_TOKEN)
                else:
                    gen = current_rng("token masking").generator(txt_tokens.device, "mask")
                    txt_input, labels = mask_tokens(gen, txt_tokens, 0.99, MASK_TOKEN,
                                                    MASK_RANGE_START, c.fusion_vocab)
            else:
                txt_input, labels = txt_tokens, lm_shift_labels(txt_tokens)
            # the question count is the rows of the per-question media (clips
            # after the device fbank), never the tiled answer rows
            media = batch.get("video_pixels")
            if media is None:
                media = batch.get("audio_spectrograms")
            n_questions = (media if media is not None else txt_tokens).shape[0]
            ls = [L.qa_weighted_cross_entropy(
                self.fusion_logits(txt_input, prompt, video_input if "v" in g else None,
                                   audio_input if "a" in g else None, True, c.full_masker),
                labels, batch.get("answer_weights"), n_questions) for g in groups]
            return {"qa_loss": sum(ls) / len(ls)}
