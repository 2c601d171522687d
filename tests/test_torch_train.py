"""Training slice of the PyTorch port against ``valor_tpu`` (tiny config, fp32, CPU).

The weights go through ``params_from_jax``; inputs are made with numpy; dropout
is 0 wherever the two packages are compared.  Tolerances, with their reasons:

  * towers, features and losses 1e-4, the whole-model tolerance of the port's
    tests (fp32 on both sides, sums in another order);
  * parameter gradients 1e-4 absolute and relative, the same;
  * dropout's keep rate within 0.005 of 0.9 over 100,000 draws (about four
    standard errors); remat against no remat 1e-5 (the same arithmetic run
    twice).

The optimizer trajectories are in tests/test_torch_optim.py.

The unimlm caption objective masks tokens at random, and the two packages
draw other bits: ``monkeypatch`` hands both the same numpy-made mask.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import tiny_model_config
from tests.test_torch_models import PT_TASK, _np, tiny_batch, torch_config
from valor_tpu.core.tasks import parse_task
from valor_tpu.models import clip as jclip
from valor_tpu.models.valor import VALORModel as JaxVALOR
from valor_tpu_torch.core.config import Config, TrainConfig
from valor_tpu_torch.core.tasks import TaskSpec
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models import clip as tclip
from valor_tpu_torch.models.bridge import init_params, load_model, params_from_jax, train_model
from valor_tpu_torch.ops import layers as tl
from valor_tpu_torch.ops.layers import RNGStreams, rng_scope
from valor_tpu_torch.train.optimizer import build_optimizer
from valor_tpu_torch.train.step import TrainState
from valor_tpu_torch.train.trainer import Trainer

TOL = 1e-4
LR = 1e-3


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def lm_models():
    """(config, JAX model, JAX params, torch model): caption_type lm, dropout 0.
    The JAX init is compiled (three times faster than running it eagerly)."""
    cfg = tiny_model_config(dropout=0.0, caption_type="lm")
    jm = JaxVALOR(cfg)
    task = parse_task(PT_TASK)
    params = jax.jit(lambda r, b: jm.init(r, b, task, True, True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, tiny_batch())["params"]
    return cfg, jm, params, train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")


@pytest.fixture(scope="module")
def jax_grad_fn(lm_models):
    """The loss and gradient of valor_tpu/train/step.py:_step_body, compiled once
    (dropout 0 and caption_type lm draw no random bits)."""
    cfg, jm, params, _ = lm_models
    task = parse_task(PT_TASK)

    def loss_fn(p, batch):
        losses = jm.apply({"params": p}, batch, task, True, True)
        return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), losses

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# -- towers and features ------------------------------------------------------

@pytest.mark.parametrize("with_prompt", [False, True])
@torch.no_grad()
def test_clip_text_tower(with_prompt):
    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 512, size=(3, 7)).astype(np.int32)
    tokens[1, 5:] = 0
    prompt = rng.randint(1, 512, size=(3, 4)).astype(np.int32) if with_prompt else None
    if with_prompt:
        prompt[2, -1] = 0
    jm = jclip.CLIPTextTransformer(jclip.text_preset("clip_vit_tiny"))
    p = jm.init(jax.random.PRNGKey(0), tokens, prompt)["params"]
    tm = tclip.CLIPTextTransformer(tclip.text_preset("clip_vit_tiny"), device="cpu")
    tm.load_state_dict(params_from_jax(_np(p)), strict=True)
    out = tm.eval()(torch.from_numpy(tokens), None if prompt is None else torch.from_numpy(prompt))
    assert out.shape == (3, 7 + (4 if with_prompt else 0), 32)
    _close(out, jm.apply({"params": p}, tokens, prompt))


@torch.no_grad()
def test_contra_features(lm_models):
    cfg, jm, params, tm = lm_models
    batch = tiny_batch(seed=1)
    ref_v = jm.apply({"params": params}, batch["video_pixels"], method=jm.encode_video)
    ref_a = jm.apply({"params": params}, batch["audio_spectrograms"], method=jm.encode_audio)
    ref = jm.apply({"params": params}, batch["clip_tokens"], ref_v, ref_a, method=jm.contra_features)
    tb = _tensors(batch)
    tm.eval()
    out = tm.contra_features(tb["clip_tokens"], tm.encode_video(tb["video_pixels"]),
                             tm.encode_audio(tb["audio_spectrograms"]))
    tm.train()
    for k in ("feat_t", "feat_v", "feat_a"):
        assert out[k].shape == ref[k].shape
        _close(out[k], ref[k])
    _close(tm.temperature(), jm.apply({"params": params}, method=jm.temperature))


# -- the pretraining forward and its gradients --------------------------------

def _fixed_mask(tokens, seed=7):
    """One numpy-made caption mask for both packages: (masked tokens, labels)."""
    rng = np.random.RandomState(seed)
    tok = np.asarray(tokens)
    pick = (rng.rand(*tok.shape) < 0.6) & (tok != 0)
    pick[:, 0] = False
    pick[np.arange(len(tok)), 1] = True
    masked = np.where(pick, 103, tok).astype(tok.dtype)
    return masked, np.where(pick, tok, -1).astype(tok.dtype)


def _patch_masks(monkeypatch):
    import valor_tpu.models.valor as jv
    import valor_tpu_torch.models.valor as tv

    def jax_mask(rng, tokens, *a):
        m, lab = _fixed_mask(tokens)
        return jnp.asarray(m), jnp.asarray(lab)

    def torch_mask(gen, tokens, *a):
        m, lab = _fixed_mask(tokens.numpy())
        return torch.from_numpy(m), torch.from_numpy(lab)

    monkeypatch.setattr(jv, "mask_tokens", jax_mask)
    monkeypatch.setattr(tv, "mask_tokens", torch_mask)


def _torch_losses_and_grads(tm, batch):
    tm.zero_grad(set_to_none=True)
    with rng_scope(RNGStreams(0)):
        out = tm(_tensors(batch), tparse(PT_TASK))
    sum(out.values()).backward()
    return out


@pytest.mark.parametrize("caption_type", ["lm", "unimlm"])
def test_forward_pt_losses_and_every_gradient(caption_type, monkeypatch, lm_models, jax_grad_fn):
    cfg, jm, params, _ = lm_models
    batch = tiny_batch(seed=2)
    if caption_type == "unimlm":
        _patch_masks(monkeypatch)
        cfg = dataclasses.replace(cfg, caption_type="unimlm")
        jm = JaxVALOR(cfg)
        task = parse_task(PT_TASK)

        def loss(p):
            out = jm.apply({"params": p}, batch, task, True, True,
                           rngs={"mask": jax.random.PRNGKey(2)})
            return sum(out.values()), out

        (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    else:
        (_, ref), grads = jax_grad_fn(params, batch)
    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")
    out = _torch_losses_and_grads(tm, batch)
    assert set(out) == set(ref) == {"contra_loss", "caption_loss"}
    for k in ref:
        _close(out[k].detach(), ref[k])
    ref_g = params_from_jax(_np(grads))
    assert set(ref_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_mlm_branch_and_other_tasks_raise(lm_models):
    cfg, jm, params, tm = lm_models
    task = "pt_contra%tv_mlm%tv%ta"
    with rng_scope(RNGStreams(3)):
        out = tm(_tensors(tiny_batch(seed=3)), tparse(task))
    assert set(out) == {"contra_loss", "mlm_loss"} and bool(torch.isfinite(out["mlm_loss"]))
    with pytest.raises(ValueError, match="xx"):  # no task family beyond pt, ret, cap and qa
        tm(_tensors(tiny_batch()), TaskSpec("xx", caption_groups=("tv",)))
    # clip-span waveforms (the device fbank) give the losses of their log-mel clips
    from valor_tpu_torch.data.fbank import clip_span_samples, fbank_clips_from_spans

    wav_batch = _tensors(tiny_batch(seed=3))
    del wav_batch["audio_spectrograms"]
    wav_batch["audio_waveforms"] = torch.from_numpy(
        np.random.RandomState(4).randn(3, 1, clip_span_samples(32)).astype(np.float32))
    wav_batch["audio_valid_frames"] = torch.tensor([[32], [5], [-1]], dtype=torch.int32)
    spec_batch = dict(wav_batch, audio_spectrograms=fbank_clips_from_spans(
        wav_batch["audio_waveforms"], wav_batch["audio_valid_frames"], melbins=16, target_length=32))
    del spec_batch["audio_waveforms"], spec_batch["audio_valid_frames"]
    with rng_scope(RNGStreams(3)):
        from_wavs = tm(wav_batch, tparse(task))
    with rng_scope(RNGStreams(3)):
        from_spec = tm(spec_batch, tparse(task))
    assert {k: float(v) for k, v in from_wavs.items()} == {k: float(v) for k, v in from_spec.items()}
    with pytest.raises(RuntimeError, match="rng_scope"):  # unimlm needs the mask stream
        load_model(torch_config(tiny_model_config()),
                   init_params(torch_config(tiny_model_config()), device="cpu"), "cpu")(
            _tensors(tiny_batch()), tparse(PT_TASK))


# -- dropout, remat and the trainer --------------------------------------------

def test_dropout_keep_rate_scaling_and_eval_identity():
    x = torch.ones(200, 500)
    with rng_scope(RNGStreams(0)):
        y = tl.dropout(x, 0.1, True)
        y2 = tl.dropout(x, 0.1, True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert not torch.equal(y, y2)  # successive draws differ
    with rng_scope(RNGStreams(0)):
        assert torch.equal(tl.dropout(x, 0.1, True), y)  # one seed, one mask
    assert tl.dropout(x, 0.1, False) is x and tl.dropout(x, 0.0, True) is x
    with pytest.raises(RuntimeError, match="rng_scope"):
        tl.dropout(x, 0.1, True)
    before = torch.random.get_rng_state()
    with rng_scope(RNGStreams(1)):
        tl.dropout(x, 0.5, True)
    assert torch.equal(torch.random.get_rng_state(), before)  # the global generator is untouched


@pytest.mark.parametrize("scope", ["all", "vision,fusion"])
def test_remat_gives_the_same_loss_and_grads_with_dropout(scope):
    cfg = torch_config(tiny_model_config(caption_type="lm", dropout=0.3))
    sd = init_params(cfg, seed=4, device="cpu")
    batch = _tensors(tiny_batch(seed=4))
    res = []
    for remat in (False, True):
        m = train_model(dataclasses.replace(cfg, checkpointing=remat, remat_scope=scope), sd, "cpu")
        with rng_scope(RNGStreams(5)):
            out = m(batch, tparse(PT_TASK))
            total = sum(out.values())
        total.backward()
        res.append((float(total.detach()), {n: p.grad.clone() for n, p in m.named_parameters()
                                   if p.grad is not None}))
    assert res[0][0] == pytest.approx(res[1][0], rel=1e-6)
    for n, g in res[0][1].items():
        torch.testing.assert_close(res[1][1][n], g, rtol=1e-5, atol=1e-6)
    m = train_model(cfg, sd, "cpu")
    with rng_scope(RNGStreams(5)):
        dropped = float(sum(m(batch, tparse(PT_TASK)).values()).detach())
    with rng_scope(RNGStreams(5)):
        m.eval()
        plain = float(sum(m(batch, tparse(PT_TASK)).values()).detach())
    assert dropped != plain  # dropout is on in training mode only


def test_remat_scope_tokens():
    assert not tl.remat_for(False, "bogus", "vision")
    assert tl.remat_for(True, "all", "audio") and not tl.remat_for(True, "none", "audio")
    assert tl.remat_for(True, "vision, text", "text") and not tl.remat_for(True, "vision", "fusion")
    for bad in ("visoin", ""):
        with pytest.raises(ValueError, match="remat_scope"):
            tl.remat_for(True, bad, "vision")


def test_init_params_temperatures_and_train_model():
    cfg = torch_config(tiny_model_config())
    sd = init_params(cfg, seed=0, device="cpu")
    assert float(sd["clip_proj.logit_scale"]) == pytest.approx(np.log(1 / 0.07))
    assert float(sd["contra_temp"]) == pytest.approx(0.07)
    m = train_model(cfg, sd, "cpu")
    assert m.training and all(p.requires_grad for p in m.parameters())
    assert float(m.temperature()) == pytest.approx(0.07, rel=1e-5)


class _Saver:
    def __init__(self):
        self.saved, self.finished = [], False

    def save(self, state, step, best_name=None):
        self.saved.append((step, state.step, best_name))

    def finish(self):
        self.finished = True


def test_trainer_counts_optimizer_steps_and_meters(lm_models):
    cfg, jm, params, _ = lm_models
    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")
    tcfg = TrainConfig(learning_rate=LR, num_train_steps=3, gradient_accumulation_steps=2,
                       valid_steps=2, train_inner_steps=4, save_best=True)
    state = TrainState(tm, build_optimizer(tm, tcfg))
    pairs = [(PT_TASK, dict(tiny_batch(seed=20 + i), ids=["x"] * 3)) for i in range(10)]
    seen, evals = [], []

    def validate(model, step):
        evals.append(step)
        return {"val": {"CIDEr": float(step)}}

    saver = _Saver()
    trainer = Trainer(Config(model=torch_config(cfg), train=tcfg), state, pairs,
                      validate_fn=validate, saver=saver,
                      step_hook=lambda micro, task, m: seen.append((micro, task)))
    trainer.run()
    # 3 optimizer steps of 2 micro-batches each; train_inner_steps is ignored
    assert state.step == 6 and state.optimizer.gradient_step == 3
    assert [m for m, _ in seen] == [1, 2, 3, 4, 5, 6]
    assert [h[0] for h in trainer.history] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(v) for _, _, d in trainer.history for v in d.values())
    assert set(trainer.meters) == {f"{PT_TASK}/{k}" for k in
                                   ("contra_loss", "caption_loss", "total_loss", "grad_norm")}
    assert evals == [2, 3] and saver.finished
    assert saver.saved == [(2, 4, "val"), (3, 6, "val")]


def test_trainer_refuses_scst():
    """SCST runs (tests/test_torch_scst.py), but not without a ``Scorer``: the
    trainer refuses it before any update."""
    cfg = torch_config(tiny_model_config(scst_finetuning=True))
    m = train_model(cfg, init_params(cfg, seed=0, device="cpu"), "cpu")
    tcfg = TrainConfig(num_train_steps=2)
    state = TrainState(m, build_optimizer(m, tcfg))
    trainer = Trainer(Config(model=cfg, train=tcfg), state, [("cap%tva", tiny_batch())])
    with pytest.raises(ValueError, match="SCST needs a Scorer"):
        trainer.run()
    assert state.step == 0 and state.optimizer.gradient_step == 0


def test_train_step_marks_its_three_parts_for_the_profiler(lm_models):
    """``train_step`` runs forward, backward and update inside the named
    ``record_function`` ranges that ``tools/profile_training.py`` splits the
    trace by, in that order; the split puts each launch in the range whose host
    interval holds it (here: a CPU trace has no kernels, so all are zero)."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from valor_tpu_torch.tools.profile_training import split_by_range
    from valor_tpu_torch.train.step import RANGES, train_step

    cfg, _, params, _ = lm_models
    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")
    state = TrainState(tm, build_optimizer(tm, TrainConfig(learning_rate=LR, num_train_steps=3)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = train_step(state, _tensors(tiny_batch()), tparse(PT_TASK), seed=0)
    assert {"total_loss", "grad_norm"} <= set(metrics) and state.step == 1
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.name in RANGES)
    assert [n for _, _, n in spans] == list(RANGES)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert split_by_range(prof.events(), RANGES) == {**dict.fromkeys(RANGES, 0.0), "outside": 0.0}

    # launches on other threads count by host time; the ranges' own device spans do not
    def ev(name, start, end, kernels=(), device="CPU"):
        return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                               time_range=SimpleNamespace(start=start, end=end),
                               kernels=[SimpleNamespace(name=k, duration=d) for k, d in kernels])

    events = [ev(RANGES[0], 0, 10, [(RANGES[0], 9000.0), ("ln_fwd", 1000.0)]),
              ev(RANGES[1], 10, 30), ev(RANGES[2], 30, 40),
              ev(RANGES[1], 12, 28, device="CUDA"),
              ev("aten::mm", 2, 3, [("gemm", 2000.0)]), ev("bwd::mm", 15, 16, [("gemm", 4000.0)]),
              ev("foreach", 31, 32, [("adam", 500.0), ("adam", 500.0)]), ev("copy", 50, 51, [("c", 250.0)])]
    assert split_by_range(events, RANGES) == {RANGES[0]: 3.0, RANGES[1]: 4.0, RANGES[2]: 1.0, "outside": 0.25}
