"""MoE fusion FFN of the PyTorch port against ``valor_tpu.ops.moe`` (fp32, CPU).

``MoEMlpBlock`` on the same weights and numpy input as the JAX block: output
and aux within 1e-5 (fp32 on both sides, sums in another order), the same
slots and drops where the capacity overflows, router and expert-stack
gradients within 1e-5.  Then the tiny VALOR with ``fusion_moe_experts=4,
fusion_moe_every=2``: ``forward_pt`` losses with ``moe_aux`` and every
gradient within 1e-4 (the whole-model tolerance), the aux sown once a layer
call with and without remat, one ``train_step`` update against the JAX
update (every element within one step of the learning rate, 1e-4), and greedy
and beam-3 captions token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _np, seeded_models, tiny_batch, torch_config
from valor_tpu_torch.core.config import TrainConfig
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models.bridge import params_from_jax, train_model
from valor_tpu_torch.ops import moe as tmoe
from valor_tpu_torch.ops.layers import RNGStreams, rng_scope, sow_scope
from valor_tpu_torch.train.optimizer import build_optimizer
from valor_tpu_torch.train.step import TrainState, train_step, with_moe_aux

G, S, M, H, E = 2, 8, 16, 32, 4
TOL = 1e-4
MOE_KW = dict(fusion_moe_experts=4, fusion_moe_every=2, dropout=0.0, caption_type="lm")
AUX_W = 0.01
TASK = "pt_contra%tva_caption%tva%tv"  # two caption groups: the MoE layer runs twice


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _blocks(top_k, capacity_factor):
    from valor_tpu.ops.moe import MoEMlpBlock

    jm = MoEMlpBlock(num_experts=E, intermediate=H, top_k=top_k, capacity_factor=capacity_factor)
    x = np.random.RandomState(0).randn(G, S, M).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), x)["params"])
    tm = tmoe.MoEMlpBlock(M, E, H, top_k, capacity_factor, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, tm, x


@pytest.mark.parametrize("top_k", [1, 2])
def test_block_output_aux_and_gradients(top_k):
    jm, params, tm, x = _blocks(top_k, 1.25)

    def loss(p, v):
        y, aux = jm.apply({"params": p}, v)
        return jnp.sum(y * jnp.cos(v)) + aux, (y, aux)

    (_, (ref_y, ref_aux)), ref_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, x)
    xt = torch.from_numpy(x)
    y, aux = tm(xt)
    (torch.sum(y * torch.cos(xt)) + aux).backward()
    _close(y.detach(), ref_y, 1e-5)
    _close(aux.detach(), ref_aux, 1e-5)
    assert float(aux.detach()) >= 1.0 - 1e-6
    ref_g = params_from_jax(_np(ref_g))
    for name, p in tm.named_parameters():
        _close(p.grad, ref_g[name], 1e-5)
    assert float(tm.router.grad.abs().sum()) > 0


def test_capacity_drops_take_the_same_slots():
    """One slot an expert (capacity_factor 1e-6, top-1): the port keeps and
    drops the same choices in the same slots, and a dropped token's output
    is 0 (the residual carries it)."""
    jm, params, tm, x = _blocks(1, 1e-6)
    ref_y, _ = jm.apply({"params": params}, x)
    with torch.no_grad():
        y, _ = tm(torch.from_numpy(x))
        r = tm.route(torch.from_numpy(x))
    _close(y, ref_y, 1e-5)
    assert r.capacity == 1
    first = np.argmax(np.einsum("gsm,me->gse", x, params["router"]), axis=-1)
    kept = r.keep.sum(-1)[0].numpy()  # [G, S]
    for g in range(G):
        claimed = set()
        for s in range(S):  # earlier tokens claim the one slot first
            assert kept[g, s] == (first[g, s] not in claimed)
            claimed.add(first[g, s])
    assert 0 < kept.sum() < G * S
    np.testing.assert_array_equal(np.asarray(y)[kept == 0], 0.0)
    assert float(r.slot.max()) == 0.0


def test_top_k_mask_takes_the_first_of_equal_gates():
    gates = torch.tensor([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]]])
    sel = tmoe.top_k_mask(gates, 2)
    assert sel[0].argmax(-1).tolist() == [[0, 1]]
    assert sel[1].argmax(-1).tolist() == [[1, 2]]


@pytest.fixture(scope="module")
def moe_models():
    return seeded_models(**MOE_KW)


@pytest.fixture(scope="module")
def jax_step(moe_models):
    """(batch, total, losses, gradients) of the JAX step's loss
    (``valor_tpu/train/step.py:_apply_losses`` with the aux weight), once."""
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.train.step import _apply_losses

    jm, params, _ = moe_models
    task = parse_task(TASK)

    def loss(p, batch):
        losses = _apply_losses(jm, p, batch, task, {}, AUX_W)
        return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), losses

    batch = tiny_batch(seed=2)
    (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch)
    return batch, total, losses, grads


def _torch_losses(tm, batch):
    tm.zero_grad(set_to_none=True)
    with rng_scope(RNGStreams(0)), sow_scope() as sown:
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse(TASK))
    out = with_moe_aux(out, sown, AUX_W)
    sum(out.values()).backward()
    return out, sown


def test_moe_valor_forward_pt_losses_and_every_gradient(moe_models, jax_step):
    jm, params, _ = moe_models
    batch, _, ref, grads = jax_step
    assert "moe_mlp" in params["multimodal_encoder"]["layer_1"]
    assert "mlp" in params["multimodal_encoder"]["layer_0"]
    tm = train_model(torch_config(jm.cfg), params_from_jax(_np(params)), "cpu")
    out, sown = _torch_losses(tm, batch)
    assert len(sown) == 2  # one MoE layer, run once for each caption group
    assert set(out) == set(ref) == {"contra_loss", "caption_loss", "moe_aux"}
    for k in ref:
        _close(out[k].detach(), ref[k], TOL)
    ref_g = params_from_jax(_np(grads))
    assert set(ref_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL, err_msg=name)
    assert float(tm.multimodal_encoder.layer_1.moe_mlp.router.grad.abs().sum()) > 0


def test_remat_sows_once_and_gives_the_same_gradients(moe_models):
    jm, params, _ = moe_models
    batch = tiny_batch(seed=3)
    runs = []
    for remat in (False, True):
        cfg = torch_config(jm.cfg)
        if remat:
            cfg = dataclasses.replace(cfg, checkpointing=True, remat_scope="fusion")
        tm = train_model(cfg, params_from_jax(_np(params)), "cpu")
        assert tm.multimodal_encoder.remat == remat
        out, sown = _torch_losses(tm, batch)
        runs.append((out, len(sown), {n: p.grad.clone() for n, p in tm.named_parameters()
                                      if p.grad is not None}))
    (o0, n0, g0), (o1, n1, g1) = runs
    assert n0 == n1 == 2
    for k in o0:
        _close(o1[k].detach(), o0[k].detach(), 1e-5)
    assert set(g0) == set(g1)
    for name in g0:
        _close(g1[name], g0[name], 1e-5)


def test_one_train_step_matches_jax(moe_models, jax_step):
    import optax

    from valor_tpu.core.config import TrainConfig as JaxTrainConfig
    from valor_tpu.train.optimizer import build_optimizer as jax_build

    jm, params, _ = moe_models
    lr = 1e-4
    kw = dict(learning_rate=lr, clip_lr=lr, clip_lr_text=lr, num_train_steps=10,
              warmup_ratio=0.0, weight_decay=0.01, grad_norm=0.5)
    batch, total, ref, grads = jax_step
    tx = jax_build(params, JaxTrainConfig(**kw))
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    ref_sd = params_from_jax(_np(optax.apply_updates(params, updates)))

    tm = train_model(torch_config(jm.cfg), params_from_jax(_np(params)), "cpu")
    state = TrainState(tm, build_optimizer(tm, TrainConfig(**kw)))
    metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                         tparse(TASK), 0, moe_aux_weight=AUX_W)
    _close(metrics["moe_aux"], ref["moe_aux"], TOL)
    _close(metrics["total_loss"], total, TOL)
    diff = torch.cat([(p.detach() - ref_sd[n]).abs().reshape(-1) for n, p in tm.named_parameters()])
    assert float(diff.max()) <= lr
    assert float((diff <= 2e-2 * lr).float().mean()) >= 0.999


@pytest.mark.parametrize("beam_size", [1, 3])
def test_sequences_match_jax(moe_models, beam_size):
    from valor_tpu.eval import generate as jgen
    from valor_tpu_torch.eval import generate as tgen

    jm, params, tm = moe_models
    batch = {k: v for k, v in tiny_batch(seed=11, b=4).items()
             if k in ("video_pixels", "audio_spectrograms")}
    ref = jgen.generate(jm, params, batch, ("tva",), max_len=6, beam_size=beam_size)
    out = tgen.generate(tm, batch, ("tva",), max_len=6, beam_size=beam_size)
    seqs = out["generated_sequences_tva"]
    assert len({tuple(r) for r in seqs.tolist()}) > 1
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(ref["generated_sequences_tva"]))


@pytest.mark.parametrize("beam_size", [1, 3])
def test_context_kv_sequences_match_jax(beam_size):
    """Without cross-attention the decode caches the [media] context's K/V,
    running the MoE layers on the context once (capacity from its tokens)
    and on the text buffer at every step (capacity from the buffer's)."""
    from valor_tpu.eval import generate as jgen
    from valor_tpu_torch.eval import generate as tgen

    jm, params, tm = seeded_models(multimodal_use_cross_attn=False, **MOE_KW)
    batch = {k: v for k, v in tiny_batch(seed=12, b=3).items()
             if k in ("video_pixels", "audio_spectrograms")}
    ref = jgen.generate(jm, params, batch, ("tva",), max_len=5, beam_size=beam_size)
    out = tgen.generate(tm, batch, ("tva",), max_len=5, beam_size=beam_size)
    np.testing.assert_array_equal(out["generated_sequences_tva"].numpy(),
                                  np.asarray(ref["generated_sequences_tva"]))
