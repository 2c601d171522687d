"""Retrieval slice of the PyTorch port against ``valor_tpu`` (tiny config, fp32, CPU).

The weights go through ``params_from_jax``, the inputs are made with numpy, and
dropout is 0.  Tolerances, with their reasons:

  * score matrices 1e-5, the op tolerance of the port's tests (fp32 on both
    sides, sums in another order);
  * ``forward_ret`` losses, features and every parameter gradient 1e-4, the
    whole-model tolerance;
  * reports equal: the same ranks from scores that agree to 1e-5.
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
from valor_tpu.eval import retrieval as jret
from valor_tpu.eval import validate as jval
from valor_tpu.models.valor import VALORModel as JaxVALOR
from valor_tpu.train.step import make_eval_step
from valor_tpu_torch.core.config import Config, TrainConfig
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.data.synthetic import retrieval_batch
from valor_tpu_torch.eval import retrieval as tret
from valor_tpu_torch.eval.validate import best_metric_name, retrieval_scores, validate_ret
from valor_tpu_torch.models.bridge import load_model, params_from_jax, train_model
from valor_tpu_torch.ops.kernels import fine_score as K2
from valor_tpu_torch.ops.layers import RNGStreams, rng_scope
from valor_tpu_torch.train.optimizer import build_optimizer
from valor_tpu_torch.train.step import TrainState, eval_step
from valor_tpu_torch.train.trainer import Trainer

SCORE_TOL = 1e-5
TOL = 1e-4
FINE_GROUPS = ["tv", "ta", "tva", "va", "vta", "atv"]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _init(cfg):
    """(JAX params, port state dict) of ``cfg``, the JAX init compiled; the
    pretraining task reaches every head the port builds."""
    jm = JaxVALOR(cfg)
    params = jax.jit(lambda r, b: jm.init(r, b, parse_task(PT_TASK), True, True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, tiny_batch())["params"]
    return params, params_from_jax(_np(params))


@pytest.fixture(scope="module")
def fine():
    cfg = tiny_model_config(dropout=0.0)
    params, sd = _init(cfg)
    return cfg, params, sd


@pytest.fixture(scope="module")
def coarse():
    cfg = tiny_model_config(dropout=0.0, contra_type="coarse")
    params, sd = _init(cfg)
    return cfg, params, sd


def _pair(cfg, params, sd, **over):
    """(JAX model, JAX params, port eval model) of ``cfg`` with ``over``."""
    cfg = dataclasses.replace(cfg, **over)
    tm = _port_model(cfg, sd)
    return JaxVALOR(cfg), params, tm


def _port_model(cfg, sd):
    """An eval-mode port model of ``cfg`` from the entries of ``sd`` it has."""
    from valor_tpu_torch.models.valor import VALORModel

    names = set(VALORModel(torch_config(cfg), device="meta").state_dict())
    return load_model(torch_config(cfg), {k: v for k, v in sd.items() if k in names}, "cpu")


def _feats(n, d, seed=0, T=3, V=4, coarse=False):
    """Features as numpy arrays (tests/test_av_retrieval.py:_feats): two valid
    tokens a caption; [n, d] rows in coarse mode."""
    rng = np.random.RandomState(seed)
    shape = (lambda k: (n, d)) if coarse else (lambda k: (n, k, d))
    txt = np.zeros((n, T), np.int32)
    txt[:, :2] = 1
    return {"feat_t": rng.randn(*shape(T)).astype(np.float32),
            "feat_v": rng.randn(*shape(V)).astype(np.float32),
            "feat_a": rng.randn(*shape(V)).astype(np.float32), "txt_tokens": txt}


def _both(feats):
    return ({k: jnp.asarray(v) for k, v in feats.items()},
            {k: torch.from_numpy(v) for k, v in feats.items()})


# -- (c) retrieval_scores ------------------------------------------------------

@pytest.mark.parametrize("group", FINE_GROUPS)
def test_fine_scores_match_jax(fine, group):
    jm, params, tm = _pair(*fine)
    jf, tf = _both(_feats(5, tm.contra_dim))
    ref = jval.retrieval_scores(jm, params, jf, group, "fine")
    got = retrieval_scores(tm, tf, group, "fine")
    assert got.dtype == torch.float32 and got.shape == ref.shape == (5, 5)
    _close(got, ref, SCORE_TOL)


@pytest.mark.parametrize("over", [{"late_fusion": True}, {"fineweight_type": "none"}],
                         ids=["late_fusion", "fineweight_none"])
def test_fine_tva_variants_match_jax(fine, over):
    jm, params, tm = _pair(*fine, **over)
    jf, tf = _both(_feats(6, tm.contra_dim, seed=1))
    _close(retrieval_scores(tm, tf, "tva", "fine"),
           jval.retrieval_scores(jm, params, jf, "tva", "fine"), SCORE_TOL)


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("group", ["tv", "ta", "tva"])
def test_coarse_scores_match_jax(coarse, group, late):
    jm, params, tm = _pair(*coarse, late_fusion=late)
    jf, tf = _both(_feats(5, tm.contra_dim, seed=2, coarse=True))
    _close(retrieval_scores(tm, tf, group, "coarse"),
           jval.retrieval_scores(jm, params, jf, group, "coarse"), SCORE_TOL)


def test_unsupported_groups_raise(fine, coarse):
    _, _, tm = _pair(*fine)
    tf = _both(_feats(5, tm.contra_dim))[1]
    tf["feat_t"], tf["txt_tokens"] = tf["feat_t"][:3], tf["txt_tokens"][:3]  # 3 captions, 5 items
    for group in ("vta", "atv"):
        with pytest.raises(ValueError, match="aligned"):
            retrieval_scores(tm, tf, group, "fine")
    _, _, tc = _pair(*coarse)
    with pytest.raises(ValueError, match="coarse"):
        retrieval_scores(tc, _both(_feats(5, tc.contra_dim, coarse=True))[1], "va", "coarse")


@pytest.mark.parametrize("group", FINE_GROUPS)
def test_eval_scores_match_the_training_score_matrix(fine, group):
    """tests/test_av_retrieval.py::TestEvalTrainScoreParity for the port: the
    gallery dispatch and the in-batch ``group_score_matrix`` agree per group."""
    _, _, tm = _pair(*fine)
    tf = _both(_feats(4, tm.contra_dim, seed=3))[1]
    with torch.no_grad():
        theirs = tm.group_score_matrix(group, tf, tf["txt_tokens"])
    _close(retrieval_scores(tm, tf, group, "fine"), theirs, SCORE_TOL)


# -- (d) the copied metrics ----------------------------------------------------

def _scores_and_ids(seed=4, items=8, captions=12):
    rng = np.random.RandomState(seed)
    ids = [f"v{i}" for i in range(items)]
    ids_txt = [ids[i % items] if i < items else ids[rng.randint(items)] for i in range(captions)]
    return rng.randn(captions, items).astype(np.float32), ids, ids_txt


@pytest.mark.parametrize("dual_softmax", [False, True])
@pytest.mark.parametrize("evaluate_ret_text", [False, True])
def test_retrieval_report_matches_jax(dual_softmax, evaluate_ret_text):
    score, ids, ids_txt = _scores_and_ids()
    want = jret.retrieval_report(score, ids, ids_txt, dual_softmax, 0.05, evaluate_ret_text)
    got = tret.retrieval_report(score, ids, ids_txt, dual_softmax, 0.05, evaluate_ret_text)
    assert got == want and ("backward_r1" in got) == evaluate_ret_text
    assert len(ids_txt) % 2 == 0  # medianR over an even count: the lower middle rank


def test_rank_metrics_dual_softmax_and_qa_accuracy_match_jax():
    score, ids, ids_txt = _scores_and_ids(seed=5)
    for direction in ("t2v", "v2t"):
        assert tret.rank_metrics(score, ids, ids_txt, direction) == jret.rank_metrics(
            score, ids, ids_txt, direction)
    np.testing.assert_array_equal(tret.dual_softmax_forward(score, 0.07),
                                  jret.dual_softmax_forward(score, 0.07))
    np.testing.assert_array_equal(tret.dual_softmax_backward(score, 0.07),
                                  jret.dual_softmax_backward(score, 0.07))
    preds, answers = ["a", "b", "c", "d"], ["a", ["x", "b"], "z", ("d",)]
    assert tret.qa_accuracy(preds, answers) == jret.qa_accuracy(preds, answers) == 75.0
    assert tret.qa_accuracy([], []) == jret.qa_accuracy([], [])


# -- (e) forward_ret -------------------------------------------------------------

@pytest.mark.parametrize("task", ["ret%tva%tv", "ret%tv"])
def test_forward_ret_losses_and_every_gradient(fine, task):
    cfg, params, sd = fine
    jm = JaxVALOR(cfg)
    spec = parse_task(task)
    batch = tiny_batch(seed=6)

    def loss(p):
        out = jm.apply({"params": p}, batch, spec, True, True)
        return out["contra_loss"], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = train_model(torch_config(cfg), sd, "cpu")
    with rng_scope(RNGStreams(0)):
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse(task))
    assert set(out) == set(ref) == {"contra_loss"}
    out["contra_loss"].backward()
    _close(out["contra_loss"].detach(), ref["contra_loss"], TOL)
    ref_g = params_from_jax(_np(grads))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_forward_ret_features(fine):
    cfg, params, sd = fine
    jm = JaxVALOR(cfg)
    spec = parse_task("ret%tva%tv")
    batch = tiny_batch(seed=7)
    ref = jm.apply({"params": params}, batch, spec, False, False)
    tm = train_model(torch_config(cfg), sd, "cpu")
    out = eval_step(tm, batch, tparse("ret%tva%tv"))
    assert tm.training  # restored
    assert set(out) == set(ref)
    for k in ("feat_t", "feat_v", "feat_a"):
        assert out[k].requires_grad is False and out[k].shape == ref[k].shape
        _close(out[k], ref[k], TOL)
    np.testing.assert_array_equal(out["txt_tokens"].numpy(), np.asarray(ref["txt_tokens"]))


def test_ret_task_text_free_group_encodes_no_text(fine):
    _, _, sd = fine
    tm = load_model(torch_config(fine[0]), sd, "cpu")
    out = eval_step(tm, tiny_batch(seed=8), tparse("ret%va"))
    assert out["feat_t"] is None and out["txt_tokens"] is None and out["feat_v"] is not None


# -- (f) validate_ret end to end -------------------------------------------------

def _gallery(n_batches=3, per=3, seed=10):
    out = []
    for i in range(n_batches):
        b = tiny_batch(seed=seed + i, b=per)
        b["ids"] = [f"v{i}{j}" for j in range(per)]
        b["ids_txt"] = list(b["ids"])
        out.append(b)
    return out


@pytest.mark.parametrize("dual_softmax,evaluate_ret_text", [(False, False), (True, True)])
def test_validate_ret_matches_jax(fine, dual_softmax, evaluate_ret_text):
    cfg, params, sd = fine
    task = "ret%tva%tv%ta%va%vta%atv"
    jm = JaxVALOR(cfg)
    want = jval.validate_ret(jm, params, make_eval_step(jm), iter(_gallery()), parse_task(task),
                             "fine", dual_softmax, evaluate_ret_text)
    tm = load_model(torch_config(cfg), sd, "cpu")
    before = K2.LAUNCHES
    got = validate_ret(tm, eval_step, iter(_gallery()), tparse(task), "fine",
                       dual_softmax, evaluate_ret_text)
    assert K2.LAUNCHES == before  # the chunked plain path on the CPU
    assert got == want and got["ravg"] == got["tva_forward_ravg"]


# -- (g) the trainer with a retrieval validation -------------------------------------

def test_trainer_tracks_best_ravg(fine):
    cfg, _, sd = fine
    tcfg = TrainConfig(learning_rate=1e-3, num_train_steps=2, valid_steps=1, save_best=True)
    tm = train_model(torch_config(cfg), sd, "cpu")
    state = TrainState(tm, build_optimizer(tm, tcfg))
    spec = tparse("ret%tva%tv")
    reports = []

    def validate(model, step):
        reports.append(validate_ret(model, eval_step, _gallery(seed=20), spec, "fine"))
        assert model.training  # eval_step restores the mode
        return {"msrvtt_ret": reports[-1]}

    pairs = [("ret%tva%tv", b) for b in _gallery(n_batches=2, seed=30)]
    trainer = Trainer(Config(model=torch_config(cfg), train=tcfg), state, pairs, validate_fn=validate)
    trainer.run()
    assert state.optimizer.gradient_step == 2 and len(reports) == 3  # steps 1, 2 and the final one
    assert trainer.best["msrvtt_ret/ravg"] == max(r["ravg"] for r in reports)
    assert set(trainer.meters) == {f"ret%tva%tv/{k}" for k in ("contra_loss", "total_loss", "grad_norm")}
    assert best_metric_name(spec) == "ravg" and best_metric_name(tparse("cap%tva")) == "CIDEr"


def test_retrieval_batch_is_seeded_and_one_caption_per_item():
    cfg = torch_config(tiny_model_config())
    a = retrieval_batch(cfg, 4, frames=3, clips=2, n_txt=10, seed=1, id_offset=8)
    b = retrieval_batch(cfg, 4, frames=3, clips=2, n_txt=10, seed=1, id_offset=8)
    assert a["ids"] == a["ids_txt"] == ["video8", "video9", "video10", "video11"]
    assert a["video_pixels"].shape == (4, 3, 32, 32, 3) and a["video_pixels"].dtype == np.uint8
    assert a["audio_spectrograms"].shape == (4, 2, 16, 32) and a["clip_tokens"].shape == (4, 10)
    for k in ("clip_tokens", "bert_tokens", "video_pixels", "audio_spectrograms"):
        np.testing.assert_array_equal(a[k], b[k])
