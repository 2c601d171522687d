"""Losses, scores and token masks of the PyTorch port against ``valor_tpu`` (CPU, fp32).

Every loss and score of ``valor_tpu_torch/tasks/losses.py`` is held to its JAX
counterpart within 1e-5 (the ops tolerance of the port's tests: fp32 sums
taken in another order), on inputs made with numpy; gradients within 1e-5 as
well.  ``full_mask`` and ``lm_shift_labels`` are exact.  ``mask_tokens`` draws
other bits than ``jax.random``, so its law is checked instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valor_tpu.ops import masking as jmask
from valor_tpu.tasks import losses as JL
from valor_tpu_torch.ops import masking as tmask
from valor_tpu_torch.tasks import losses as TL

TOL = 1e-5
t = torch.from_numpy


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _labels(rng, shape, vocab, ignore=0.4):
    lab = rng.randint(0, vocab, size=shape).astype(np.int64)
    lab[rng.rand(*shape) < ignore] = -1
    return lab


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_masked_cross_entropy(smoothing):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 7, 50) * 3).astype(np.float32)
    labels = _labels(rng, (3, 7), 50)
    ref = JL.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    _close(TL.masked_cross_entropy(t(logits), t(labels), smoothing), ref)
    g_ref = jax.grad(lambda x: JL.masked_cross_entropy(x, jnp.asarray(labels), smoothing))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    TL.masked_cross_entropy(x, t(labels), smoothing).backward()
    _close(x.grad, g_ref)


def test_masked_cross_entropy_all_ignored_is_zero():
    logits = torch.randn(2, 3, 11)
    labels = -torch.ones(2, 3, dtype=torch.long)
    assert float(TL.masked_cross_entropy(logits, labels)) == 0.0


def test_contrastive_loss():
    rng = np.random.RandomState(1)
    s = rng.randn(6, 6).astype(np.float32)
    temp = np.float32(0.07)
    _close(TL.contrastive_loss(t(s), torch.tensor(temp)),
           JL.contrastive_loss(jnp.asarray(s), jnp.asarray(temp)))
    g_ref = jax.grad(lambda x, tt: JL.contrastive_loss(x, tt), argnums=(0, 1))(
        jnp.asarray(s), jnp.asarray(temp))
    x, tt = t(s).requires_grad_(True), torch.tensor(temp, requires_grad=True)
    TL.contrastive_loss(x, tt).backward()
    _close(x.grad, g_ref[0])
    _close(tt.grad, g_ref[1], tol=1e-3 * abs(float(g_ref[1])) + TOL)  # d/dtemp ~ 1/temp^2


def test_coarse_score_and_l2_normalize():
    rng = np.random.RandomState(2)
    a = rng.randn(4, 9).astype(np.float32)
    b = rng.randn(5, 9).astype(np.float32)
    na, nb = TL.l2_normalize(t(a)), TL.l2_normalize(t(b))
    _close(na, JL.l2_normalize(jnp.asarray(a)))
    _close(TL.coarse_score(na, nb), JL.coarse_score(JL.l2_normalize(jnp.asarray(a)),
                                                    JL.l2_normalize(jnp.asarray(b))))
    assert float(TL.l2_normalize(torch.zeros(3)).abs().sum()) == 0.0  # eps, no NaN


@pytest.mark.parametrize("negative", [False, True])
def test_fine_score_with_masked_tokens(negative):
    """Masked text tokens (padding) and, with ``negative``, rows whose every
    similarity is below zero: the masked zeros then win the max, as in JAX."""
    rng = np.random.RandomState(3)
    fa = rng.randn(5, 7, 12).astype(np.float32)
    fb = rng.randn(6, 4, 12).astype(np.float32)
    if negative:
        fb = -np.abs(fb)
        fa = np.abs(fa)
    ma = (rng.rand(5, 7) > 0.3).astype(np.float32)
    ma[:, 0] = 1.0
    mb = np.ones((6, 4), np.float32)
    mb[2, 3] = 0.0
    wa = rng.randn(5, 7).astype(np.float32)
    wb = rng.randn(6, 4).astype(np.float32)
    args = (fa, fb, ma, mb, wa, wb)
    ref = JL.fine_score(*map(jnp.asarray, args))
    _close(TL.fine_score(*map(t, args)), ref)
    g_ref = jax.grad(lambda a, b, x, y: jnp.sum(jnp.sin(JL.fine_score(a, b, jnp.asarray(ma),
                                                                       jnp.asarray(mb), x, y))),
                     argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in (fa, fb, wa, wb)))
    ins = [t(v).requires_grad_(True) for v in (fa, fb, wa, wb)]
    torch.sin(TL.fine_score(ins[0], ins[1], t(ma), t(mb), ins[2], ins[3])).sum().backward()
    for x, g in zip(ins, g_ref):
        _close(x.grad, g)


def _tokens(rng, b=64, n=12, vocab=500):
    tok = rng.randint(106, vocab, size=(b, n)).astype(np.int64)
    tok[:, 0] = 101
    lengths = rng.randint(2, n + 1, size=b)
    for i, length in enumerate(lengths):
        tok[i, length:] = 0
    return tok


def test_full_mask_and_lm_shift_labels_match_jax():
    tok = _tokens(np.random.RandomState(4), b=5, n=9)
    for got, want in zip(tmask.full_mask(t(tok), 103), jmask.full_mask(jnp.asarray(tok), 103)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tmask.lm_shift_labels(t(tok)).numpy(),
                                  np.asarray(jmask.lm_shift_labels(jnp.asarray(tok))))


def test_mask_tokens_law():
    """Position 0 and pads are never masked; eligible positions are masked at
    mask_prob (within 4 standard errors); labels hold the source token where
    masked and -1 elsewhere; masked slots become [MASK], a random token in
    range or stay themselves at 80 / 10 / 10 percent."""
    tok = t(_tokens(np.random.RandomState(5), b=400, n=24))
    gen = torch.Generator().manual_seed(0)
    out, labels = tmask.mask_tokens(gen, tok, 0.3, 103, 106, 500)
    masked = labels != -1
    eligible = tok != 0
    eligible[:, 0] = False
    assert not bool((masked & ~eligible).any())
    assert torch.equal(labels[masked], tok[masked])
    assert torch.equal(out[~masked], tok[~masked])
    rate = float(masked.sum()) / float(eligible.sum())
    se = (0.3 * 0.7 / float(eligible.sum())) ** 0.5
    assert abs(rate - 0.3) < 4 * se + 0.01  # the forced masks add a little
    o, s = out[masked], tok[masked]
    n = float(masked.sum())
    is_mask = float((o == 103).sum()) / n
    unchanged = float((o == s).sum()) / n
    assert abs(is_mask - 0.8) < 0.04 and abs(unchanged - 0.1 - 0.8 / 394) < 0.03
    assert bool(((o == 103) | ((o >= 106) & (o < 500))).all())
    # one seed, one draw
    again = tmask.mask_tokens(torch.Generator().manual_seed(0), tok, 0.3, 103, 106, 500)
    assert torch.equal(again[0], out) and torch.equal(again[1], labels)


def test_mask_tokens_forces_one_mask_per_row():
    tok = t(_tokens(np.random.RandomState(6), b=50, n=10))
    tok[3, 1:] = 0  # a row with no eligible position keeps no mask
    _, labels = tmask.mask_tokens(torch.Generator().manual_seed(1), tok, 0.0, 103, 106, 500)
    per_row = (labels != -1).sum(1)
    assert int(per_row[3]) == 0
    others = torch.ones(50, dtype=torch.bool)
    others[3] = False
    assert bool((per_row[others] == 1).all())
    # the forced position is spread over the eligible ones
    tok1 = t(np.full((2000, 6), 200, np.int64))
    _, lab1 = tmask.mask_tokens(torch.Generator().manual_seed(2), tok1, 0.0, 103, 106, 500)
    counts = (lab1 != -1).sum(0)
    assert int(counts[0]) == 0 and int(counts[1:].min()) > 300
