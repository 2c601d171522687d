"""Autoregressive caption/QA generation (counterpart of ``valor_tpu/eval/generate.py``).

  * greedy or multinomial sampling with an 'unfinished' latch that pins
    finished rows to EOS; returns per-step logprobs of the sampled tokens.
    A sampled token is picked by inverse CDF, the first whose fp32
    cumulative probability passes a uniform draw; the rollout's uniforms are
    drawn at once at the global batch's shape and this rank's rows taken
    (``parallel/mesh.py:draw_rows``), so W ranks sample what one process
    samples (the bits of ``torch.multinomial`` depend on the batch's shape);
  * beam search with per-beam score carrying, where a finished beam keeps its
    score for every candidate word; candidates are ranked by a stable
    descending sort, so ties go to the lowest flat index as ``lax.top_k``
    gives them;
  * unimlm queries are [BOS, state..., MASK] and the MASK position is scored;
    lm queries are [BOS, state...] scoring the last position.

Every step re-runs the fusion encoder on a fixed-size token buffer (no
self-attention K/V cache for the text), exactly as the JAX package does; with
cross-attention the per-layer media K/V are projected once per rollout, and
without it (``multimodal_use_cross_attn=False``: the media join the sequence)
the self-attention K/V of the [prompt | video | audio] context are computed
once per rollout and every step attends to them (``fusion_ctx_kv``).
The decode runs eagerly: a step's kernels are launched one by one.
"""

from __future__ import annotations

import collections
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from valor_tpu_torch.data.fbank import fbank_clips_from_spans
from valor_tpu_torch.models.valor import BOS_TOKEN, EOS_TOKEN, MASK_TOKEN
from valor_tpu_torch.parallel.mesh import draw_rows

# DecoderFn(txt_tokens [B,N], token_mask [B,N]) -> logits over positions [B,N,V]
DecoderFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

NEG = -1e9  # beam score of the not-yet-started beams (not the attention mask value)


def _buffer_len(max_len: int, caption_type: str) -> int:
    # unimlm: [BOS | L generated | trailing MASK slot]; lm: [BOS | L generated]
    return max_len + 2 if caption_type == "unimlm" else max_len + 1


def _prepare_step(buffer: torch.Tensor, t: int, caption_type: str):
    """(tokens, token_mask, read_pos) for step t on the fixed buffer."""
    pos = torch.arange(buffer.shape[-1], device=buffer.device)
    if caption_type == "unimlm":
        read_pos = t + 1
        tokens = torch.where(pos[None] == read_pos, MASK_TOKEN, buffer)
    else:
        read_pos = t
        tokens = buffer
    mask = (pos[None] <= read_pos).float().expand(buffer.shape)
    return tokens, mask, read_pos


def greedy_or_sample(
    decoder: DecoderFn,
    batch_size: int,
    max_len: int,
    caption_type: str = "unimlm",
    mode: str = "greedy",
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sequences [B, max_len] filled with EOS after finish,
    logprobs [B, max_len] of the sampled tokens, zeros in greedy mode).
    Sampling draws from ``generator`` (on the decode's device) one uniform a
    row and step, [B, max_len] at once (at the global batch's shape inside a
    ``parallel.mesh.batch_shard``), before the first step."""
    n = _buffer_len(max_len, caption_type)
    buffer = torch.zeros((batch_size, n), dtype=torch.long, device=device)
    buffer[:, 0] = BOS_TOKEN
    sents = torch.full((batch_size, max_len), EOS_TOKEN, dtype=torch.long, device=device)
    logps = torch.zeros((batch_size, max_len), device=device)
    unfinished = torch.ones((batch_size,), dtype=torch.bool, device=device)
    if mode != "greedy":
        u = draw_rows(lambda shape: torch.rand(shape, generator=generator, device=device), (batch_size, max_len))
    for t in range(max_len):
        tokens, mask, read_pos = _prepare_step(buffer, t, caption_type)
        step_logits = decoder(tokens, mask)[:, read_pos].float()
        if mode == "greedy":
            wt = torch.argmax(step_logits, dim=-1)
        else:
            logp = torch.log_softmax(step_logits, dim=-1)
            wt = inverse_cdf(logp.exp(), u[:, t])
            logps[:, t] = torch.gather(logp, 1, wt[:, None])[:, 0]
        wt = torch.where(unfinished, wt, EOS_TOKEN)
        unfinished = unfinished & (wt != EOS_TOKEN)
        buffer[:, t + 1] = wt
        sents[:, t] = wt
    return sents.to(torch.int32), logps


def inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each row of ``probs`` [B, V] (fp32, summing to about 1) the first
    index whose cumulative probability exceeds ``u`` [B] in [0, 1) times the
    row's total: a draw from the row's distribution that a zero-probability
    index never takes."""
    cdf = torch.cumsum(probs, dim=-1)
    x = (u.to(cdf.dtype) * cdf[:, -1])[:, None]
    return torch.searchsorted(cdf, x, right=True)[:, 0].clamp_(max=probs.shape[-1] - 1)


def beam_search(
    decoder: DecoderFn,
    batch_size: int,
    beam_size: int,
    max_len: int,
    caption_type: str = "unimlm",
    device=None,
) -> torch.Tensor:
    """Best sequences [B, max_len].

    The decoder is called on B*K rows every step (media already expanded to
    B*K rows by the caller).  At t=0 every beam but the first carries NEG, so
    the first ranking draws K distinct words from beam 0."""
    k_beam = beam_size
    n = _buffer_len(max_len, caption_type)
    buffer = torch.zeros((batch_size, k_beam, n), dtype=torch.long, device=device)
    buffer[:, :, 0] = BOS_TOKEN
    score = torch.full((batch_size, k_beam), NEG, device=device)
    score[:, 0] = 0.0
    alive = torch.ones((batch_size, k_beam), dtype=torch.bool, device=device)
    for t in range(max_len):
        flat = buffer.reshape(batch_size * k_beam, n)
        tokens, mask, read_pos = _prepare_step(flat, t, caption_type)
        step_logp = torch.log_softmax(decoder(tokens, mask)[:, read_pos].float(), dim=-1)
        step_logp = step_logp.reshape(batch_size, k_beam, -1)
        vocab = step_logp.shape[-1]
        # a finished beam keeps its score for every candidate word
        step_logp = torch.where(alive[:, :, None], step_logp, 0.0)
        cand = (score[:, :, None] + step_logp).reshape(batch_size, -1)
        top_score, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
        score, top_idx = top_score[:, :k_beam], top_idx[:, :k_beam]
        sel_beam = torch.div(top_idx, vocab, rounding_mode="floor")
        sel_word = top_idx % vocab
        buffer = torch.gather(buffer, 1, sel_beam[:, :, None].expand(-1, -1, n))
        alive = torch.gather(alive, 1, sel_beam) & (sel_word != EOS_TOKEN)
        buffer[:, :, t + 1] = sel_word
    best = torch.argmax(score, dim=1)
    out = buffer[torch.arange(batch_size, device=buffer.device), best]
    seqs = out[:, 1 : max_len + 1]
    # finished beams carry tie-break words after their EOS: pin them to EOS
    hit = torch.cumsum((seqs == EOS_TOKEN).int(), dim=1) > 0
    return torch.where(hit, EOS_TOKEN, seqs).to(torch.int32)


def expand_rows(x: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    """[B, ...] -> [B*k, ...] row repeat."""
    if x is None or k == 1:
        return x
    return torch.repeat_interleave(x, k, dim=0)


def make_fusion_decoder(
    model,
    prompt_tokens: Optional[torch.Tensor],
    video_input: Optional[torch.Tensor],
    audio_input: Optional[torch.Tensor],
    full_masker: bool = False,
) -> DecoderFn:
    """Bind fixed media and prompt inputs into a DecoderFn over the text buffer.

    With cross-attention the per-layer cross K/V are projected once here and
    reused by every decode step; without it the [prompt | media] context's
    self-attention K/V are computed once here (exact under the causal-prefix
    mask, see ``models/bert.py:precompute_ctx_kv``)."""
    has_media = video_input is not None or audio_input is not None
    cross_kv = None
    if model.cfg.multimodal_use_cross_attn and has_media:
        cross_kv = model.fusion_cross_kv(video_input, audio_input)
        video_input = audio_input = None  # the media now live in the cache
    elif not model.cfg.multimodal_use_cross_attn and (has_media or prompt_tokens is not None):
        ctx_kv, ctx_mask = model.fusion_ctx_kv(prompt_tokens, video_input, audio_input)

        def ctx_decoder(tokens, token_mask):
            return model.fusion_logits_ctx(tokens, token_mask, ctx_kv, ctx_mask)

        return ctx_decoder

    def decoder(tokens, token_mask):
        return model.fusion_logits(
            tokens, prompt_tokens, video_input, audio_input, True, full_masker,
            token_mask, cross_kv,
        )

    return decoder


def _decode(model, caption_type, max_len, beam_size, mode, prompt, v, a, generator):
    bsz = next(x.shape[0] for x in (v, a, prompt) if x is not None)
    if prompt is not None and prompt.shape[0] == 1:
        prompt = prompt.expand((bsz,) + tuple(prompt.shape[1:]))
    if beam_size > 1:
        dec = make_fusion_decoder(
            model, expand_rows(prompt, beam_size), expand_rows(v, beam_size),
            expand_rows(a, beam_size))
        seqs = beam_search(dec, bsz, beam_size, max_len, caption_type, model.device)
        return seqs, torch.zeros((bsz, max_len), device=model.device)
    dec = make_fusion_decoder(model, prompt, v, a)
    return greedy_or_sample(dec, bsz, max_len, caption_type, mode, generator, model.device)


class Generator:
    """Generation over one model, with the decode routines bound per
    (caption_type, max_len, beam_size, mode) key.

    Nothing is compiled: the cache holds one bound decode routine per key
    and ``stats()`` reports, per key, how many batches it decoded."""

    def __init__(self, model):
        self.model = model
        self._decoders: Dict[Any, Callable] = {}
        self._calls: "collections.Counter[Any]" = collections.Counter()

    def _decoder(self, caption_type: str, max_len: int, beam_size: int, mode: str):
        key = ("decode", caption_type, max_len, beam_size, mode)
        fn = self._decoders.get(key)
        if fn is None:
            fn = functools.partial(_decode, self.model, caption_type, max_len, beam_size, mode)
            self._decoders[key] = fn
        self._calls[key] += 1
        return fn

    def stats(self) -> Dict[Any, int]:
        """(decoder key) -> number of batches decoded through it."""
        return dict(self._calls)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.model.device)

    def encode(self, batch: Dict[str, Any], groups: Tuple[str, ...]):
        """The fusion-space (video_input, audio_input) of the batch's media for
        ``groups`` (None where no group uses a modality), clip-span
        ``audio_waveforms`` through the device fbank first.  Autograd follows
        the caller's mode (SCST encodes under ``torch.no_grad``)."""
        m = self.model
        video_input = audio_input = None
        if any("v" in g for g in groups) and batch.get("video_pixels") is not None:
            video_input = m.video_fusion_input(m.encode_video(self._tensor(batch["video_pixels"])))
        if any("a" in g for g in groups):
            spec = batch.get("audio_spectrograms")
            if batch.get("audio_waveforms") is not None:
                # the device fbank: clip-span waveforms to log-mel clips, as
                # VALORModel.forward turns them on the training path
                spec = fbank_clips_from_spans(
                    self._tensor(batch["audio_waveforms"]),
                    self._tensor(batch["audio_valid_frames"]),
                    melbins=m.cfg.audio_melbins, target_length=m.cfg.audio_target_length,
                ).to(m.dtype)
            if spec is not None:
                audio_input = m.audio_fusion_input(m.encode_audio(self._tensor(spec)))
        return video_input, audio_input

    @torch.inference_mode()
    def generate(
        self,
        batch: Dict[str, Any],
        groups: Tuple[str, ...],
        *,
        caption_type: str = "unimlm",
        max_len: int = 30,
        beam_size: int = 1,
        mode: str = "greedy",
        generator: Optional[torch.Generator] = None,
        prompt_key: str = "prompt_tokens_caption",
    ) -> Dict[str, torch.Tensor]:
        """Encode the batch's media once (``encode``), then decode each
        modality group.  Returns {'generated_sequences_<g>': [B, max_len]
        int32, 'logprobs_<g>': [B, max_len] fp32}, on the model's device."""
        video_input, audio_input = self.encode(batch, groups)
        tile = batch.get("tile_index")
        if tile is not None:
            tile = self._tensor(tile).long()
            video_input = video_input[tile] if video_input is not None else None
            audio_input = audio_input[tile] if audio_input is not None else None

        prompt = batch.get("question_prompt", batch.get(prompt_key))
        if prompt is not None:
            prompt = self._tensor(prompt)
        decode = self._decoder(caption_type, max_len, beam_size, mode)
        out: Dict[str, torch.Tensor] = {}
        for g in groups:
            v = video_input if "v" in g else None
            a = audio_input if "a" in g else None
            seqs, logps = decode(prompt, v, a, generator)
            out[f"generated_sequences_{g}"] = seqs
            out[f"logprobs_{g}"] = logps
        return out


def generate(model, batch: Dict[str, Any], groups: Tuple[str, ...], **kw) -> Dict[str, torch.Tensor]:
    """One-shot :meth:`Generator.generate`."""
    return Generator(model).generate(batch, groups, **kw)
