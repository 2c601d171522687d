"""SCST (self-critical sequence training) policy-gradient loss (counterpart of
``valor_tpu/tasks/scst.py``).

reference: model/pretrain.py:741-791 (forward_cap_scst) and :166-173
(reward_loss).  The greedy and sampled rollouts and the host CIDEr+BLEU
reward live in ``train/trainer.py:Trainer.scst_step``; the update that takes
this loss's gradient is ``train/step.py:scst_update``.

For unimlm decoding, the step conditionals P(s_j | BOS, s_0..s_{j-1}, MASK) of
every j come from one forward through the full-masker two-stream layout
(``ops/masks.py``): the input is [BOS, s_0..s_{L-2} | MASK*L], where mask
position j sees exactly the prefix up to s_{j-1} and carries its shifted
position id, so scoring the rollout needs no re-decode.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from valor_tpu_torch.models.valor import BOS_TOKEN, EOS_TOKEN, MASK_TOKEN
from valor_tpu_torch.parallel.collectives import sharded_mean


def scst_loss(
    model,
    batch: Dict[str, Any],
    sequences: torch.Tensor,  # [B, L] sampled rollout (EOS-filled)
    rewards: torch.Tensor,  # [B] advantage (sample - alpha * greedy)
    caption_type: str,
    prompt_key: str = "prompt_tokens_caption",
    use_video: bool = True,
    use_audio: bool = True,
) -> torch.Tensor:
    """The reward-weighted negative log-likelihood of ``sequences`` under
    teacher forcing, averaged over the selected positions: position j counts
    where j == 0 or s_{j-1} is not EOS (pretrain.py:166-169).  ``batch`` holds
    the fusion-space ``video_input``/``audio_input`` and the prompt.  In a
    training step across ranks the average is over the global batch's
    positions (``sharded_mean``: this rank's share of it)."""
    sequences = sequences.long()
    b, l = sequences.shape
    bos = torch.full((b, 1), BOS_TOKEN, dtype=sequences.dtype, device=sequences.device)
    if caption_type == "unimlm":
        masks = torch.full((b, l), MASK_TOKEN, dtype=sequences.dtype, device=sequences.device)
        txt_input = torch.cat([bos, sequences[:, :-1], masks], dim=1)  # [B, 2L]
        full_masker, start = True, l
    else:  # lm
        txt_input = torch.cat([bos, sequences[:, :-1]], dim=1)
        full_masker, start = False, 0
    logits = model.fusion_logits(
        txt_input, batch.get(prompt_key),
        batch.get("video_input") if use_video else None,
        batch.get("audio_input") if use_audio else None,
        True, full_masker, None,
    )
    logp = torch.log_softmax(logits[:, start : start + l].float(), dim=-1)
    tok_logp = torch.gather(logp, -1, sequences[..., None])[..., 0]
    prev_not_eos = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=sequences.device),
         sequences[:, :-1] != EOS_TOKEN], dim=1)
    sel = prev_not_eos.float()
    weighted = -tok_logp * rewards.float()[:, None] * sel
    return sharded_mean(weighted.sum(), sel.sum())
