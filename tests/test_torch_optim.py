"""Optimizer of the PyTorch port against ``valor_tpu`` (tiny config, fp32, CPU).

Three optimizer updates of the port (``train/optimizer.py`` through
``train/step.py:train_step``) against the same updates of the JAX package
(``build_optimizer`` and the loss and gradient of ``train/step.py:_step_body``)
from the same weights and numpy-made batches, with caption_type lm and dropout
0 so that no random bits are drawn.  Tolerances, with their reasons: losses
1e-4 (the whole-model tolerance); 99.9 % of the parameter elements within 2 %
of one step's learning rate (lr 1e-3, so 2e-5 absolute) and every element
within one step.  Adam divides each gradient by its own running RMS, so where
a gradient is near zero (or, under bf16 gradients, near a rounding boundary)
a relative difference of the gradient becomes a relative difference of the
step, up to a fraction of one step.  Also: parameter labels and schedules.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_models import PT_TASK, _np, tiny_batch, torch_config
from tests.test_torch_train import _close, _tensors, jax_grad_fn, lm_models  # noqa: F401 (fixtures)
from valor_tpu.core.config import TrainConfig as JaxTrainConfig
from valor_tpu_torch.core.config import TrainConfig
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models.bridge import params_from_jax, train_model
from valor_tpu_torch.train.optimizer import build_optimizer, flax_path, label_params
from valor_tpu_torch.train.step import TrainState, train_step

LR = 1e-3


TRAIN_KW = dict(learning_rate=LR, clip_lr=LR, clip_lr_text=LR, num_train_steps=10,
                warmup_ratio=0.1, weight_decay=0.01, grad_norm=0.5)

VARIANTS = {  # (TrainConfig keys, build_optimizer keys); grad_norm 0.5 clips every step
    "adamw_clip": ({}, {}),
    "frozen_vision_accum2": ({"gradient_accumulation_steps": 2}, {"frozen_vision": True}),
    "nu_and_grads_bf16": ({"adam_nu_dtype": "bfloat16", "grad_dtype": "bfloat16"}, {}),
    "adamax": ({"optim": "adamax"}, {}),
}


def _jax_trajectory(grad_fn, params, tcfg, frozen_vision, batches):
    from valor_tpu.train.optimizer import build_optimizer as jax_build
    from valor_tpu.train.step import _cast_grads

    tx = jax_build(params, tcfg, frozen_vision=frozen_vision)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    losses = []
    for b in batches:
        (total, _), grads = grad_fn(params, b)
        grads = _cast_grads(grads, tcfg.grad_dtype)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(total))
    return losses, params


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_optimizer_steps_match_jax(variant, lm_models, jax_grad_fn):
    cfg, jm, params, _ = lm_models
    tkw, okw = VARIANTS[variant]
    accum = tkw.get("gradient_accumulation_steps", 1)
    batches = [tiny_batch(seed=10 + i) for i in range(3 * accum)]
    jcfg = JaxTrainConfig(**TRAIN_KW, **tkw)
    ref_losses, ref_params = _jax_trajectory(jax_grad_fn, params, jcfg,
                                             okw.get("frozen_vision", False), batches)

    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")
    tcfg = TrainConfig(**TRAIN_KW, **tkw)
    state = TrainState(tm, build_optimizer(tm, tcfg, **okw))
    losses = [float(train_step(state, _tensors(b), tparse(PT_TASK), 0, tcfg.grad_dtype)["total_loss"])
              for b in batches]
    assert state.step == 3 * accum and state.optimizer.gradient_step == 3
    _close(losses, ref_losses)
    ref_sd, start = params_from_jax(_np(ref_params)), params_from_jax(_np(params))
    names = [n for n, _ in tm.named_parameters()]
    diff = torch.cat([(p.detach() - ref_sd[n]).abs().reshape(-1) for n, p in tm.named_parameters()])
    assert float(diff.max()) <= LR, names[int(np.argmax([float((p.detach() - ref_sd[n]).abs().max())
                                                        for n, p in tm.named_parameters()]))]
    assert float((diff <= 2e-2 * LR).float().mean()) >= 0.999
    moved = sum(not torch.equal(ref_sd[n], start[n]) for n in names)
    assert moved > 100  # the steps did move the weights
    for name, p in tm.named_parameters():
        if okw.get("frozen_vision") and name.startswith("clip_vision."):
            assert torch.equal(p.detach(), start[name]), name


def test_labels_match_jax_labels(lm_models):
    """The trouble spot: the port names a LayerNorm scale ``weight``; its label
    must still be no-decay, as the JAX package gives the flax ``scale``."""
    from valor_tpu.train.optimizer import label_params as jax_labels

    cfg, jm, params, tm = lm_models
    for fv in (False, True):
        flat = jax.tree_util.tree_flatten_with_path(jax_labels(params, ["fine_weight"], fv, False))[0]
        by_path = {"/".join(str(k.key) for k in path): v for path, v in flat}
        got = label_params(tm, ["fine_weight"], fv, False)
        assert len(got) == len(by_path)
        for mod_name, mod in tm.named_modules():
            for p_name, _ in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{p_name}" if mod_name else p_name
                assert got[name] == by_path[flax_path(mod, mod_name, p_name)], name
    assert got["clip_vision.ln_pre.weight"] == "frozen"
    assert label_params(tm)["audio_encoder.block_0.ln1.weight"] == "basic_nd"


def test_schedules_match_jax():
    from valor_tpu.train.schedule import make_schedule as jax_sched
    from valor_tpu_torch.train.schedule import make_schedule

    for name in ("warmup_linear", "warmup_cosine", "warmup_constant"):
        ours, ref = make_schedule(name, 1e-4, 37, 0.1), jax_sched(name, 1e-4, 37, 0.1)
        for step in (0, 2, 3, 4, 20, 36, 40):
            assert abs(float(ours(step)) - float(ref(step))) <= 1e-12, (name, step)
