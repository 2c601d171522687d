"""Checkpoints of the PyTorch port (CPU): save and restore, exact resume, and the
load-time surgery against ``valor_tpu.train.checkpoints``.

  * Exact resume mirrors tests/test_resume_faultinjection.py: a run stopped
    after a dangling micro-step under gradient accumulation 2, saved, restored
    into a fresh model and optimizer and continued, ends with parameters and
    optimizer state equal bit for bit to an uninterrupted run's.
  * ``bilinear_resize_pos_embed`` (``jax.image.resize``'s bilinear, antialiased
    when it shrinks, written in numpy) within 1e-6 of JAX's: fp32 sums in
    another order; every other leaf of ``adapt_pretrained_params`` exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.conftest import tiny_model_config
from tests.test_torch_models import torch_config
from valor_tpu.train import checkpoints as jck
from valor_tpu_torch.core.config import Config, TrainConfig
from valor_tpu_torch.models.bridge import init_params, params_from_jax, train_model
from valor_tpu_torch.train import checkpoints as tck
from valor_tpu_torch.train.optimizer import build_optimizer
from valor_tpu_torch.train.step import TrainState
from valor_tpu_torch.train.trainer import Trainer

TASK = "pt_contra%tv_caption%tv"
N_STEPS = 6  # optimizer steps
ACCUM = 2  # micro-batches per optimizer step
KILL_AT_MICRO = 5  # mid-accumulation: 2 full steps + 1 dangling micro


def _batch(seed):
    r = np.random.RandomState(seed)
    txt = r.randint(106, 500, size=(4, 8)).astype(np.int32)
    txt[:, 0] = 101
    txt[:, -1] = 0
    return {"bert_tokens": txt, "video_pixels": r.randn(4, 1, 32, 32, 3).astype(np.float32)}


def _build(accum=ACCUM):
    mcfg = torch_config(tiny_model_config(fusion_vocab=512, txt_encoder_type="bert_base_uncased",
                                          init_clip_head=False))
    tcfg = TrainConfig(num_train_steps=N_STEPS, gradient_accumulation_steps=accum, learning_rate=1e-3,
                       clip_lr=1e-3, clip_lr_text=1e-3, valid_steps=0, seed=0)
    model = train_model(mcfg, init_params(mcfg, seed=0, device="cpu"), "cpu")
    return Config(model=mcfg, train=tcfg), TrainState(model, build_optimizer(model, tcfg))


def _micro_batches():
    return [(f"{TASK}--fix", _batch(100 + i)) for i in range(N_STEPS * ACCUM)]


def _opt_tensors(opt):
    sd = opt.state_dict()
    return sd["mu"] + sd["nu"] + (sd["acc"] or [])


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (na, pa), (nb, pb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert na == nb
        assert torch.equal(pa, pb), na
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k in ("names", "count", "mini_step", "gradient_step"):
        assert oa[k] == ob[k], k
    for ta, tb in zip(_opt_tensors(a.optimizer), _opt_tensors(b.optimizer)):
        assert torch.equal(ta, tb)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("resume")
    batches = _micro_batches()
    cfg, state = _build()
    final_a = Trainer(cfg, state, list(batches)).run()

    cfg, state = _build()
    saver = tck.ModelSaver(str(out))
    killed = Trainer(cfg, state, list(batches[:KILL_AT_MICRO]), saver=saver).run()
    assert killed.step == KILL_AT_MICRO
    assert saver.latest_step() == KILL_AT_MICRO // ACCUM

    cfg, fresh = _build()  # a fresh process: build, then restore
    restored = saver.restore()
    assert restored["micro_step"] == KILL_AT_MICRO and restored["step"] == KILL_AT_MICRO // ACCUM
    tck.load_state(fresh, restored)
    _assert_states_equal(fresh, killed)
    final_b = Trainer(cfg, fresh, list(batches[KILL_AT_MICRO:])).run()
    return final_a, final_b, killed


class TestExactResume:
    def test_params_bit_identical(self, runs):
        final_a, final_b, _ = runs
        assert final_a.step == final_b.step == N_STEPS * ACCUM
        for (n, a), b in zip(final_a.model.state_dict().items(), final_b.model.state_dict().values()):
            assert torch.equal(a, b), n

    def test_opt_state_bit_identical(self, runs):
        final_a, final_b, _ = runs
        _assert_states_equal(final_a, final_b)
        assert final_a.optimizer.gradient_step == N_STEPS

    def test_dangling_micro_grads_survive_checkpoint(self, runs):
        _, _, killed = runs
        assert killed.optimizer.mini_step == 1
        assert any(bool(a.abs().sum() > 0) for a in killed.optimizer.acc)


class TestModelSaver:
    def test_round_trip_is_bit_exact(self, tmp_path):
        cfg, state = _build()
        Trainer(cfg, state, _micro_batches()[:3]).run()
        saver = tck.ModelSaver(str(tmp_path))
        saver.save(state, 7)
        assert os.listdir(tmp_path / "ckpt") == ["step_7"]
        cfg, other = _build()
        tck.load_state(other, saver.restore(step=7))
        _assert_states_equal(state, other)

    def test_layout_best_and_remove_before(self, tmp_path):
        _, state = _build(accum=1)
        saver = tck.ModelSaver(str(tmp_path))
        saver.save(state, 1, best_name="msrvtt")
        saver.save(state, 2)
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["best_msrvtt", "step_2"]
        assert saver.latest_step() == 2
        keep = tck.ModelSaver(str(tmp_path), remove_before_ckpt=False)
        keep.save(state, 3)
        keep.save(state, 4)
        assert sorted(os.listdir(tmp_path / "ckpt")) == ["best_msrvtt", "step_2", "step_3", "step_4"]
        assert tck.ModelSaver(str(tmp_path / "empty")).restore() is None

    def test_saving_twice_at_one_step_keeps_it(self, tmp_path):
        """The trainer's periodic save at its last step, then its final save."""
        _, state = _build(accum=1)
        saver = tck.ModelSaver(str(tmp_path))
        saver.save(state, 3)
        saver.save(state, 3)
        assert saver.latest_step() == 3 and saver.restore() is not None

    def test_async_checkpoint_is_accepted_and_synchronous(self, tmp_path):
        _, state = _build(accum=1)
        saver = tck.ModelSaver(str(tmp_path), use_async=True)
        saver.save(state, 1)
        saver.finish()
        assert saver.use_async and [s for s, _, _ in saver.writes] == [1]  # written in the background
        assert saver.restore()["step"] == 1

    def test_optimizer_state_must_match(self):
        _, a = _build(accum=1)
        _, b = _build(accum=2)
        with pytest.raises(ValueError, match="gradient_accumulation_steps"):
            b.optimizer.load_state_dict(a.optimizer.state_dict())
        sd = a.optimizer.state_dict()
        with pytest.raises(ValueError, match="parameter list"):
            a.optimizer.load_state_dict(dict(sd, names=sd["names"][::-1]))


# -- surgery ------------------------------------------------------------------
@pytest.mark.parametrize("src,dst", [(2, 3), (3, 2), (7, 14), (14, 7), (14, 24), (24, 14), (5, 5)])
def test_bilinear_resize_pos_embed_matches_jax(src, dst):
    pos = np.random.RandomState(src * 31 + dst).randn(1 + src * src, 8).astype(np.float32)
    got = tck.bilinear_resize_pos_embed(pos, dst)
    want = jck.bilinear_resize_pos_embed(pos, dst)
    assert got.shape == want.shape == (1 + dst * dst, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], pos[0])


@pytest.mark.parametrize("src_hw,dst_hw,has_cls", [((8, 12), (6, 20), True), ((4, 4), (4, 9), False)])
def test_bilinear_resize_2d_matches_jax(src_hw, dst_hw, has_cls):
    pos = np.random.RandomState(0).randn(has_cls + src_hw[0] * src_hw[1], 4).astype(np.float32)
    np.testing.assert_allclose(tck.bilinear_resize_pos_embed_2d(pos, src_hw, dst_hw, has_cls),
                               jck.bilinear_resize_pos_embed_2d(pos, src_hw, dst_hw, has_cls),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [2, 5, 9])
def test_extend_frame_embedding_matches_jax(n):
    fe = np.random.RandomState(n).randn(1, 5, 6).astype(np.float32)
    np.testing.assert_array_equal(tck.extend_frame_embedding(fe, n), jck.extend_frame_embedding(fe, n))


def _tree(grid, frames, seed, dense_out=4):
    r = np.random.RandomState(seed)
    return {
        "clip_vision": {"positional_embedding": r.randn(1 + grid * grid, 8).astype(np.float32),
                        "proj": {"kernel": r.randn(8, dense_out).astype(np.float32),
                                 "bias": r.randn(dense_out).astype(np.float32)}},
        "video_frame_embedding": r.randn(1, frames, 8).astype(np.float32),
        "clip_text": {"positional_embedding": r.randn(6, 8).astype(np.float32)},
        "ln": {"scale": r.randn(8).astype(np.float32)},
    }


@pytest.mark.parametrize("grid,frames,dense_out", [(3, 8, 4), (1, 2, 4), (2, 4, 5)])
def test_adapt_pretrained_params_matches_jax(grid, frames, dense_out):
    """Resized position embeddings, extended or cut frame embeddings, leaves of
    matching shape taken, a mismatched one (the projection with another
    width) and a missing one (no ``ln`` in the source) left to the target."""
    src, dst = _tree(2, 4, seed=1), _tree(grid, frames, seed=2, dense_out=dense_out)
    del src["ln"]
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jck.adapt_pretrained_params(src, dst)))
    got = tck.adapt_pretrained_params(params_from_jax(src), params_from_jax(dst))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def test_adapt_keeps_target_dtype_and_device():
    dst = {k: v.to(torch.bfloat16) for k, v in params_from_jax(_tree(3, 8, seed=2)).items()}
    got = tck.adapt_pretrained_params(params_from_jax(_tree(2, 4, seed=1)), dst)
    assert all(v.dtype == torch.bfloat16 and v.device.type == "cpu" for v in got.values())


def test_trainer_resumes_at_the_state_step(tmp_path):
    """A state restored at micro-step 4 of accumulation 2 trains steps 3 to 6."""
    cfg, state = _build()
    state.step = 4
    trainer = Trainer(cfg, state, _micro_batches()[4:])
    trainer.run()
    assert state.step == N_STEPS * ACCUM and [h[0] for h in trainer.history] == list(range(5, 13))
