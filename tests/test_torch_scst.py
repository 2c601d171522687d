"""SCST caption finetuning of the PyTorch port against ``valor_tpu`` (CPU, fp32).

Tolerances, with their reasons:

  * the reward (``eval/scorer.py``) to 1e-12 and the ``AdaptiveAlpha``
    trajectories exactly: the port keeps a copy of the same host Python;
  * ``scst_loss`` and every parameter gradient 1e-4, the whole-model tolerance
    of the port's tests (fp32 on both sides, sums in another order);
  * one ``Trainer.scst_step``: rewards equal, losses 1e-4, updated parameters
    1e-4 at a learning rate of 1e-4 (an Adam update moves a parameter by about
    the learning rate whatever its gradient's size, so two packages' updates of
    a near-zero gradient may differ by up to twice that; see
    tests/test_torch_optim.py), and ``state.step`` one a group.

The rollouts draw from ``jax.random`` in one package and ``torch.Generator``
in the other, so the ``Trainer.scst_step`` test hands both the same greedy and
sampled sequences (``monkeypatch``), as tests/test_torch_train.py hands them
the same masks.  JAX is imported inside the tests.
"""

import json
import sys

import numpy as np
import pytest
import torch

from tests.test_data import TINY_VOCAB
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models.bridge import params_from_jax, train_model

TOL = 1e-4
LR = 1e-4


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.fixture
def annotations(tmp_path):
    """A vocabulary and ``{id: [captions]}`` with several references an id
    (one id as a bare string, punctuation and capitals for ``_clean``)."""
    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    ann = {"a": ["A cat sits on the mat.", "the cat sits", "a cat, on a mat!"],
           "b": ["The dog runs", "a dog runs on the mat"],
           "c": "the mat",
           "d": ["a dog sits on the cat", "dogs run", "the cat runs on the dog", "a mat"]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    return str(tmp_path / "ann.json"), str(tmp_path / "vocab.txt"), sorted(ann)


def _scorers(annotations, ids=None):
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JTok
    from valor_tpu.eval.scorer import Scorer as JScorer
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer as TTok
    from valor_tpu_torch.eval.scorer import Scorer

    path, vocab, all_ids = annotations
    ids = ids or all_ids
    return JScorer(path, ids, JTok(vocab)), Scorer(path, ids, TTok(vocab))


def test_scorer_rewards_match_jax(annotations):
    jscore, tscore = _scorers(annotations)
    assert tscore.refs == jscore.refs
    rng = np.random.RandomState(0)
    ids = ["a", "b", "c", "d", "a", "d"]
    hyps = [list(rng.randint(106, 118, size=rng.randint(0, 9))) for _ in ids]
    hyps[0] = [106, 107, 115, 108, 109, 110]  # "a cat sit on the mat": high CIDEr
    got, want = tscore(ids, hyps), jscore(ids, hyps)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[0] > 1.0 and (got >= 0).all()


def test_scorer_fits_cider_on_the_training_ids_only(annotations):
    """The document frequencies come from the ids it was given, not the file."""
    jscore, tscore = _scorers(annotations, ids=["a", "b"])
    assert set(tscore.refs) == {"a", "b"}
    assert tscore.cider.df == jscore.cider.df
    assert tscore.cider.log_ref_count == jscore.cider.log_ref_count == np.log(2)


@pytest.mark.parametrize("alpha_type", [0, 1, 2])
def test_adaptive_alpha_trajectory_matches_jax(alpha_type):
    from valor_tpu.eval.scorer import AdaptiveAlpha as JAlpha
    from valor_tpu_torch.eval.scorer import AdaptiveAlpha

    rng = np.random.RandomState(alpha_type)
    j, t = JAlpha(alpha_type, beta=0.7, recent=3), AdaptiveAlpha(alpha_type, beta=0.7, recent=3)
    assert t.value() == j.value() == 1.0
    for i in range(8):
        s, g = rng.rand(4).astype(np.float32), rng.rand(4).astype(np.float32)
        if i == 2:
            g[:] = 0  # a zero greedy mean counts as ratio 1
        j.update(s, g)
        t.update(s, g)
        assert t.value() == j.value()
        np.testing.assert_array_equal(t.recent, j.recent)
    with pytest.raises(ValueError):
        AdaptiveAlpha(3).value()


# -- the policy-gradient loss ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    from tests.test_torch_caption import tiny_jax_params

    return tiny_jax_params()


def _rollout(seed=0, b=4, length=6):
    """Sampled sequences with an EOS mid-row (and EOS filling after it), a row
    with no EOS, and mixed-sign advantages; fusion-space media."""
    rng = np.random.RandomState(seed)
    seqs = rng.randint(106, 512, size=(b, length)).astype(np.int32)
    seqs[0, 2:] = 102
    seqs[2, 4:] = 102
    rewards = np.asarray([1.5, -0.7, 0.3, -2.0], np.float32)[:b]
    media = {"video_input": rng.randn(b, 10, 32).astype(np.float32),
             "audio_input": rng.randn(b, 5, 32).astype(np.float32)}
    return seqs, rewards, media


@pytest.mark.parametrize("caption_type", ["unimlm", "lm"])
@pytest.mark.parametrize("group", ["tva", "tv"])
def test_scst_loss_and_every_gradient_match_jax(caption_type, group, jax_params):
    import jax

    from tests.test_torch_models import _np, torch_config
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu.tasks.scst import scst_loss as jloss
    from valor_tpu_torch.tasks.scst import scst_loss
    from valor_tpu_torch.train.step import param_grads

    cfg, params = jax_params
    seqs, rewards, media = _rollout()
    jm = JaxVALOR(cfg)
    kw = dict(use_video="v" in group, use_audio="a" in group)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, media, seqs, rewards, caption_type, **kw)))(params)
    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu").eval()
    tmedia = {k: torch.from_numpy(v) for k, v in media.items()}
    got = scst_loss(tm, tmedia, torch.from_numpy(seqs), torch.from_numpy(rewards), caption_type, **kw)
    _close(got.detach(), want)
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, param_grads(got, list(tm.parameters()))))
    ref = params_from_jax(_np(jgrads))
    assert set(ref) == set(grads)
    for n in names:
        np.testing.assert_allclose(grads[n].numpy(), ref[n].numpy(), rtol=TOL, atol=TOL, err_msg=n)
    assert float(grads["cls_head.decoder_bias"].abs().max()) > 0
    assert float(grads["clip_vision.ln_pre.weight"].abs().max()) == 0  # the media are constants


# -- one SCST step of the trainer ---------------------------------------------

def _patch_rollouts(monkeypatch, greedy, sample):
    """Both packages' decodes in the SCST step return the given sequences,
    by mode, and record the calls."""
    import jax.numpy as jnp

    import valor_tpu.eval.generate as jgen
    import valor_tpu_torch.train.trainer as ttrainer

    calls = {"jax": [], "torch": []}

    def jax_decode(self, caption_type, max_len, beam_size, mode):
        def run(params, prompt, v, a, rng):
            calls["jax"].append((mode, v is not None, a is not None))
            seqs = greedy if mode == "greedy" else sample
            return jnp.asarray(seqs), jnp.zeros(seqs.shape, jnp.float32)
        return run

    def torch_decode(model, caption_type, max_len, beam_size, mode, prompt, v, a, generator):
        calls["torch"].append((mode, v is not None, a is not None))
        if mode == "sample":
            assert generator is not None and generator.device == model.device
        seqs = greedy if mode == "greedy" else sample
        return torch.from_numpy(seqs), torch.zeros(seqs.shape)

    monkeypatch.setattr(jgen.Generator, "_decode", jax_decode)
    monkeypatch.setattr(ttrainer, "_decode", torch_decode)
    return calls


def test_trainer_scst_step_matches_jax(annotations, jax_params, monkeypatch):
    import dataclasses

    from tests.test_torch_models import _np, tiny_batch, torch_config
    from valor_tpu.core.config import Config as JConfig
    from valor_tpu.core.config import TrainConfig as JTrainConfig
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu.train.optimizer import build_optimizer as jbuild
    from valor_tpu.train.step import TrainState as JState
    from valor_tpu.train.trainer import Trainer as JTrainer
    from valor_tpu_torch.core.config import Config, TrainConfig
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState
    from valor_tpu_torch.train.trainer import Trainer

    cfg, params = jax_params
    cfg = dataclasses.replace(cfg, scst_finetuning=True, caption_type="unimlm", dropout=0.1)
    ids = ["a", "b", "d"]
    batch = tiny_batch(seed=5, b=3)
    greedy = np.full((3, 6), 102, np.int32)
    greedy[:, :3] = [[106, 107, 115], [109, 111, 112], [106, 111, 102]]
    sample = np.full((3, 6), 102, np.int32)
    sample[:, :5] = [[106, 107, 108, 109, 110], [111, 112, 102, 106, 106], [106, 111, 115, 108, 109]]
    calls = _patch_rollouts(monkeypatch, greedy, sample)
    spec = "cap%tva%tv"
    kw = dict(learning_rate=LR, num_train_steps=10, warmup_ratio=0.0)

    jscore, tscore = _scorers(annotations)
    jm = JaxVALOR(cfg)
    tx = jbuild(params, JTrainConfig(**kw))
    jt = JTrainer(JConfig(model=cfg, train=JTrainConfig(**kw)), jm, tx, JState.create(params, tx), [],
                  scorer=jscore)
    want = jt.scst_step(dict(batch), ids, parse_task(spec))

    tcfg = torch_config(cfg)
    tm = train_model(tcfg, params_from_jax(_np(params)), "cpu")
    state = TrainState(tm, build_optimizer(tm, TrainConfig(**kw)))
    tt = Trainer(Config(model=tcfg, train=TrainConfig(**kw)), state, [], scorer=tscore)
    got = tt.scst_step({k: torch.from_numpy(v) for k, v in batch.items()}, ids, tparse(spec))

    assert calls["torch"] == calls["jax"] == [("greedy", True, True), ("sample", True, True),
                                              ("greedy", True, False), ("sample", True, False)]
    assert set(got) == set(want) == {"scst_reward_tva", "caption_loss_tva", "scst_reward_tv",
                                     "caption_loss_tv"}
    for g in ("tva", "tv"):
        assert float(got[f"scst_reward_{g}"]) == np.float32(want[f"scst_reward_{g}"])
        _close(float(got[f"caption_loss_{g}"]), want[f"caption_loss_{g}"])
    assert float(got["scst_reward_tva"]) > 0
    assert state.step == int(jt.state.step) == 2 and state.optimizer.gradient_step == 2
    assert tt.alpha.idx == jt.alpha.idx == 2
    assert tm.training  # the training mode comes back after the dropout-free update
    ref = params_from_jax(_np(jt.state.params))
    start = params_from_jax(_np(params))
    moved = 0
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), rtol=0, atol=TOL, err_msg=n)
        moved += not torch.equal(p.detach(), start[n])
    # every parameter moves: the towers by the decoupled weight decay of their zero gradients
    assert moved >= len(ref) - sum(1 for n in ref if ref[n].ndim <= 1 or "embedding" in n)


def test_trainer_runs_scst_batches_and_logs_the_reward(annotations, jax_params, monkeypatch):
    """``Trainer.run`` sends ``cap`` batches to ``scst_step`` when
    ``scst_finetuning`` is on: one micro-step a batch, one update a group, the
    metrics ``scst_reward_{g}`` and ``caption_loss_{g}`` in its meters."""
    import dataclasses

    from tests.test_torch_models import _np, tiny_batch, torch_config
    from valor_tpu_torch.core.config import Config, TrainConfig
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState
    from valor_tpu_torch.train.trainer import Trainer

    cfg, params = jax_params
    tcfg = torch_config(dataclasses.replace(cfg, scst_finetuning=True))
    tm = train_model(tcfg, params_from_jax(_np(params)), "cpu")
    train = TrainConfig(learning_rate=LR, num_train_steps=2)
    state = TrainState(tm, build_optimizer(tm, train))
    pairs = [("cap%tva--fix", dict(tiny_batch(seed=i, b=3), ids=["a", "b", "d"])) for i in range(3)]
    _, tscore = _scorers(annotations)
    trainer = Trainer(Config(model=tcfg, train=train), state, pairs, scorer=tscore)
    trainer.run()
    assert state.step == 2 and [h[0] for h in trainer.history] == [1, 2]
    assert set(trainer.meters) == {"cap%tva--fix/scst_reward_tva", "cap%tva--fix/caption_loss_tva"}
    assert all(np.isfinite(v) for _, _, d in trainer.history for v in d.values())


# -- cli.train from disk ---------------------------------------------------------

@pytest.fixture(scope="module")
def cap_dataset(tmp_path_factory):
    from valor_tpu_torch.data.synthetic import write_caption_dataset

    root = tmp_path_factory.mktemp("msrvtt_scst")
    return write_caption_dataset(str(root), n_train=8, n_val=6, captions_per_id=3, n_frames=6,
                                 frame_size=(64, 48), wav_seconds=1.0, workers=2)


def test_main_finetunes_by_scst_from_a_caption_run(cap_dataset, tmp_path, monkeypatch):
    """``cli.train`` on a caption fixture: a caption run, then an SCST run
    with ``--scst_finetuning true --pretrain_dir <caption run>`` that starts
    from the caption run's weights, logs ``scst_reward_tva`` and validates."""
    from tests.test_torch_cli import TINY, _flow
    from valor_tpu_torch.cli.train import main

    monkeypatch.setenv("VALOR_BERT_VOCAB", cap_dataset["vocab"])
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "no_weights"))
    # the golden-file tests stub tensorboardX (SummaryWriter=object) for the rest of their process
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)
    base = {**TINY, "learning_rate": 1e-3, "num_train_steps": 2, "valid_steps": 0, "beam_size": 2,
            "data_cfg": {"train": [_flow(cap_dataset, "train", "cap%tva", 4)],
                         "val": [_flow(cap_dataset, "val", "cap%tva", 4)]}}
    for name in ("cap", "scst"):
        (tmp_path / f"{name}.json").write_text(json.dumps({**base, "output_dir": str(tmp_path / name)}))
    first = main(["--config", str(tmp_path / "cap.json"), "--device", "cpu"])
    trained = {k: v.clone() for k, v in first.state.model.state_dict().items()}

    import valor_tpu_torch.train.trainer as T

    seen = []
    step0 = T.Trainer.scst_step

    def spy(self, batch, ids, spec):
        if not seen:
            seen.append({k: torch.equal(v, trained[k]) for k, v in self.state.model.state_dict().items()})
        return step0(self, batch, ids, spec)

    monkeypatch.setattr(T.Trainer, "scst_step", spy)
    second = main(["--config", str(tmp_path / "scst.json"), "--scst_finetuning", "true",
                   "--pretrain_dir", str(tmp_path / "cap"), "--device", "cpu"])
    assert seen and all(seen[0].values())  # the SCST run began from the caption run's weights
    assert second.scorer is not None and set(second.scorer.refs) == set(
        json.load(open(cap_dataset["train_ids"])))
    assert [h[0] for h in second.history] == [1, 2] and second.state.step == 2
    assert all(set(h[2]) == {"scst_reward_tva", "caption_loss_tva"} for h in second.history)
    assert all(np.isfinite(v) for h in second.history for v in h[2].values())
    log = (tmp_path / "scst" / "log" / "train.log").read_text()
    assert "eval fix @ 2" in log
    assert any(not torch.equal(v, trained[k]) for k, v in second.state.model.state_dict().items())
