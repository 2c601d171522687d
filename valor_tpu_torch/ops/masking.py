"""Token masking for the caption and MLM objectives (counterpart of ``valor_tpu/ops/masking.py``).

``mask_tokens`` draws from an explicit ``torch.Generator``, never from torch's
global generator.  It reproduces the JAX package's law, not its bits:

  * position 0 (BOS/CLS) and pad positions are never masked;
  * each eligible position is masked independently w.p. ``mask_prob``;
  * a row where nothing got masked gets one forced mask on a uniformly
    chosen eligible position (Gumbel argmax);
  * a masked position becomes [MASK] w.p. ``replace_prob``, a random token in
    [range_start, range_end) w.p. ``random_prob``, and stays itself otherwise;
  * labels are the source token at masked positions and -1 elsewhere.

Inside a ``parallel.mesh.batch_shard`` every draw is made at the global batch's
shape and this rank's rows taken, so ranks mask what one process masks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from valor_tpu_torch.parallel.mesh import draw_rows


def mask_tokens(
    generator: torch.Generator,
    tokens: torch.Tensor,  # [B, N] int, 0 = pad
    mask_prob: float,
    mask_token: int,
    range_start: int = 106,
    range_end: int = 30522,
    replace_prob: float = 0.8,
    random_prob: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked tokens, labels) with labels == -1 on unmasked slots."""
    b, n = tokens.shape
    dev = tokens.device
    eligible = tokens != 0
    eligible[:, 0] = False  # never mask position 0

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    indicator = eligible & (draw_rows(rand, (b, n)) < mask_prob)

    need_force = ~indicator.any(dim=1) & eligible.any(dim=1)
    u = draw_rows(rand, (b, n)).clamp_min(1e-20)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(eligible, gumbel, torch.full_like(gumbel, -float("inf")))
    forced = torch.zeros_like(indicator)
    forced[torch.arange(b, device=dev), scores.argmax(dim=1)] = True
    indicator = torch.where(need_force[:, None], indicator | forced, indicator)

    action = draw_rows(rand, (b, n))
    rand_tok = draw_rows(lambda shape: torch.randint(range_start, range_end, shape, generator=generator,
                                                     device=dev, dtype=tokens.dtype), (b, n))
    masked = torch.where(action < replace_prob, torch.full_like(tokens, mask_token), tokens)
    masked = torch.where((action >= replace_prob) & (action < replace_prob + random_prob),
                         rand_tok, masked)
    out = torch.where(indicator, masked, tokens)
    labels = torch.where(indicator, tokens, torch.full_like(tokens, -1))
    return out, labels


def full_mask(tokens: torch.Tensor, mask_token: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stream full masking: [tokens | MASK * n]; the label of mask-stream
    position n + j (j < n - 1) is tokens[j + 1] where that is not pad."""
    b, n = tokens.shape
    doubled = torch.cat([tokens, torch.full_like(tokens, mask_token)], dim=1)
    labels = torch.full_like(doubled, -1)
    nxt = tokens[:, 1:]
    labels[:, n : 2 * n - 1] = torch.where(nxt != 0, nxt, torch.full_like(nxt, -1))
    return doubled, labels


def lm_shift_labels(tokens: torch.Tensor) -> torch.Tensor:
    """Next-token labels for the 'lm' caption mode; -1 where the next token is pad or absent."""
    labels = torch.zeros_like(tokens)
    labels[:, :-1] = tokens[:, 1:]
    return torch.where(labels == 0, torch.full_like(labels, -1), labels)
