"""Generative QA of the PyTorch port against ``valor_tpu`` (CPU, fp32).

Tolerances, with their reasons:

  * ``qa_weighted_cross_entropy`` and its gradient 1e-5, the ops tolerance of
    the port's tests (fp32 sums in another order);
  * ``forward_qa``'s loss and every parameter gradient 1e-4, the whole-model
    tolerance: one answer a question, several answers tiled with weights
    (``tile_index``, ``answer_weights``), audio-only ``qa%ta`` (the question
    count read from the audio rows, also from clip-span waveforms), and the
    unimlm mask at QA's rate of 0.99 patched into both packages;
  * the QA mapper, dataset and collates exactly (the training mapper draws
    its pair with the global ``random``: the same seed in both packages);
  * from a disk fixture: the first training batch equal and its loss within
    1e-4 (the whole-model tolerance); ``validate_qa`` with the same weights:
    reports and dumped JSON equal; ``cli.train`` end to end.

JAX is imported inside the parity tests, so that the card test (marked
``cuda``) also runs where only the port is installed.
"""

import dataclasses
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.data.synthetic import write_qa_dataset

TOL = 1e-4
t = torch.from_numpy


@pytest.fixture(scope="module")
def jax_params():
    from tests.test_torch_caption import tiny_jax_params

    return tiny_jax_params()


# -- the loss -------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_qa_weighted_cross_entropy(weighted):
    import jax
    import jax.numpy as jnp

    from valor_tpu.tasks import losses as JL
    from valor_tpu_torch.tasks import losses as TL

    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 5, 40) * 3).astype(np.float32)
    labels = rng.randint(0, 40, size=(6, 5)).astype(np.int64)
    labels[rng.rand(6, 5) < 0.4] = -1
    labels[2] = -1  # a row with no valid token
    w = np.array([1.0, 0.7, 0.3, 0.5, 0.5, 0.0], np.float32) if weighted else None
    n_q = 4 if weighted else None

    def jloss(x):
        return JL.qa_weighted_cross_entropy(x, jnp.asarray(labels), None if w is None else jnp.asarray(w), n_q)

    x = t(logits).requires_grad_(True)
    got = TL.qa_weighted_cross_entropy(x, t(labels), None if w is None else t(w), n_q)
    np.testing.assert_allclose(float(got), float(jloss(jnp.asarray(logits))), rtol=1e-5, atol=1e-5)
    got.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(logits))),
                               rtol=1e-5, atol=1e-5)
    if weighted:  # no question count: the row count divides
        np.testing.assert_allclose(float(TL.qa_weighted_cross_entropy(t(logits), t(labels), t(w))),
                                   float(JL.qa_weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                                      jnp.asarray(w))), rtol=1e-5)


# -- forward_qa -------------------------------------------------------------------

def qa_batch(case, seed=31, q=3, res=32, mel=16, alen=32):
    """A tiny QA training batch in the layout of ``valorqa_collate_train``."""
    rng = np.random.RandomState(seed)
    tile = {"single": [0, 1, 2]}.get(case, [0, 1, 1, 2, 2, 2, 0, 0])
    rows = len(tile)
    ans = rng.randint(106, 512, size=(rows, 7)).astype(np.int32)
    ans[:, 0], ans[:, 3], ans[:, 4:] = 101, 102, 0
    qs = rng.randint(106, 512, size=(rows, 6)).astype(np.int32)
    qs[:, 0], qs[:, -1] = 101, 102
    batch = {"bert_tokens": ans, "question_prompt": qs,
             "video_pixels": rng.randn(q, 2, res, res, 3).astype(np.float32),
             "audio_spectrograms": rng.randn(q, 1, mel, alen).astype(np.float32)}
    if case != "single":
        batch["tile_index"] = np.asarray(tile, np.int32)
        batch["answer_weights"] = np.array([1.0, 0.6, 0.4, 0.5, 0.3, 0.2, 0.0, 0.0], np.float32)
    if case.startswith("audio"):
        del batch["video_pixels"]
    if case == "audio_waveforms":
        from valor_tpu_torch.data.fbank import clip_span_samples

        del batch["audio_spectrograms"]
        batch["audio_waveforms"] = rng.randn(q, 1, clip_span_samples(alen)).astype(np.float32)
        batch["audio_valid_frames"] = np.array([[alen], [7], [-1]], np.int32)
    return batch


@pytest.mark.parametrize("case,task", [("single", "qa%tva"), ("tiled", "qa%tva%tv"), ("audio", "qa%ta"),
                                       ("audio_waveforms", "qa%ta")])
def test_forward_qa_loss_and_every_gradient(case, task, jax_params):
    from tests.test_torch_caption import check_losses_and_grads, losses_and_grads

    cfg, params = jax_params
    ref, ref_g, out, tm = losses_and_grads(cfg, params, qa_batch(case), task)
    assert set(out) == {"qa_loss"}
    check_losses_and_grads(ref, ref_g, out, tm)


def test_forward_qa_counts_questions_from_the_media_rows(jax_params, monkeypatch):
    """The weighted loss divides by the media rows (3 questions), never by the
    8 tiled answer rows, also for audio-only QA; and unimlm masks answers at 0.99."""
    from tests.test_torch_caption import check_losses_and_grads, losses_and_grads, patch_masks
    from valor_tpu_torch.tasks import losses as TL

    cfg, params = jax_params
    seen = []
    loss0 = TL.qa_weighted_cross_entropy
    monkeypatch.setattr(TL, "qa_weighted_cross_entropy",
                        lambda *a: seen.append(a[3]) or loss0(*a))
    probs = []
    patch_masks(monkeypatch, probs)
    unimlm = dataclasses.replace(cfg, caption_type="unimlm")
    ref, ref_g, out, tm = losses_and_grads(unimlm, params, qa_batch("audio"), "qa%ta")
    check_losses_and_grads(ref, ref_g, out, tm)
    assert seen == [3] and probs == [("jax", 0.99), ("torch", 0.99)]


@pytest.mark.cuda
def test_qa_step_card_vs_cpu():
    """The tiny ``qa%tva`` step on a multi-answer batch (``tile_index``,
    ``answer_weights``) on the card against the CPU: losses and every gradient
    within 1e-4 (``chip_smoke.py``'s check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    out = chip_smoke.phase_train_card_vs_cpu("cuda", "qa%tva")
    assert out["max_loss_diff"] <= 1e-4 and out["max_grad_diff"] <= 1e-4


# -- the QA data path -----------------------------------------------------------

@pytest.fixture
def qa_fixture(tmp_path):
    """tests/test_qa_scst.py's fixture."""
    from tests.test_data import TINY_VOCAB

    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    qa = {
        "v0": [{"question": "a cat", "answer": "the mat"}],
        "v1": [{"question": "the dog", "answer": ["cat", "mat"], "answer_weights": [0.7, 0.3]}],
        "v2": [{"question": "a cat", "answer": "dog", "question_id": 7},
               {"question": "the mat", "answer": "cat", "question_id": 8}],
    }
    (tmp_path / "qa.json").write_text(json.dumps(qa))
    (tmp_path / "ids.json").write_text(json.dumps(["v0", "v1", "v2"]))
    return tmp_path


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("training", [True, False])
def test_qa_mapper_dataset_and_collates_match_jax(qa_fixture, training):
    from valor_tpu.data import vqa as J
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JTok
    from valor_tpu_torch.data import vqa as T
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer as TTok

    vocab, qa, ids = (str(qa_fixture / f) for f in ("vocab.txt", "qa.json", "ids.json"))
    out = {}
    for name, M, tok in (("jax", J, JTok(vocab)), ("torch", T, TTok(vocab))):
        random.seed(5)  # the training mapper's pair draws
        mapper = M.QATxtMapper(qa, max_len=6, bert_tokenizer=tok, training=training)
        ds = M.VALORQADataset(ids, mapper, None, None, training)
        rng = np.random.RandomState(0)
        samples = [dict(ds[i], video=rng.randn(2, 8, 8, 3).astype(np.float32)) for i in range(len(ds))]
        collate = M.valorqa_collate_train if training else M.valorqa_collate_test
        out[name] = (samples, collate(samples), collate(samples[:1]))
    _assert_same(out["torch"], out["jax"])
    samples, batch, single = out["torch"]
    if training:
        # 1 + 2 + 1 answers, padded to 8 with zero-weight copies of row 0
        assert batch["bert_tokens"].shape == (8, 7) and batch["question_prompt"].shape == (8, 8)
        np.testing.assert_array_equal(batch["tile_index"], [0, 1, 1, 2, 0, 0, 0, 0])
        np.testing.assert_allclose(batch["answer_weights"][:4], [1.0, 0.7, 0.3, 1.0])
        assert "tile_index" not in single  # one answer a question: no tiling
    else:
        assert batch["answers"] == ["the mat", ["cat", "mat"], "dog", "cat"]
        assert batch["question_ids"] == [7, 8]
        np.testing.assert_array_equal(batch["tile_index"], [0, 1, 2, 2])


def test_multiple_choice_training_sample_raises():
    from valor_tpu_torch.data.vqa import valorqa_collate_train

    with pytest.raises(ValueError, match="multiple-choice"):
        valorqa_collate_train([{"id": "v", "qa": {"question": {}, "answer_index": 1}, "video": None,
                                "audio": None}])


# -- validate_qa and cli.train from disk ----------------------------------------

@pytest.fixture(scope="module")
def qa_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("msrvtt_qa")
    return write_qa_dataset(str(root), n_train=8, n_val=6, n_frames=6, frame_size=(64, 48),
                            wav_seconds=1.0, workers=2)


def test_first_training_batch_and_loss_match_jax(qa_dataset, monkeypatch):
    """The QA fixture's training flow through both packages' ``cli/build.py``, with the
    same ``random`` seed for the pair draws (media at their deterministic
    evaluation crop): equal batches, and the first batch's ``qa%tva`` loss
    (waveforms through each device fbank) within 1e-4."""
    import jax.numpy as jnp

    import valor_tpu.cli.build as JB
    from tests.test_torch_caption import disk_models
    from tests.test_torch_cli import TINY, _flow
    from valor_tpu.core.config import load_config as jload
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.data import native
    from valor_tpu_torch.cli import build as TB
    from valor_tpu_torch.core.config import load_config as tload

    monkeypatch.setattr(native, "available", lambda: False)  # the JAX mapper's PIL branch
    monkeypatch.setattr(JB, "DEFAULT_BERT_VOCAB", qa_dataset["vocab"])
    monkeypatch.setenv("VALOR_BERT_VOCAB", qa_dataset["vocab"])
    raw = dict(TINY, data_cfg={"train": [_flow(qa_dataset, "train", "qa%tva", 4)]})
    batches = []
    for build, load in ((JB, jload), (TB, tload)):
        cfg = load(None, dict(raw))
        flow = cfg.data_train[0]
        ds = build.build_dataset(flow, cfg.model, build.build_tokenizers(cfg.model), training=True)
        ds.video_mapper.training = ds.audio_mapper.training = False
        random.seed(11)
        batches.append(build.collate_for(flow.task, True)([ds[i] for i in range(4)]))
    _assert_same(batches[1], batches[0])
    batch = {k: v for k, v in batches[0].items() if isinstance(v, np.ndarray)}
    assert batch["bert_tokens"].shape == (4, 7) and batch["question_prompt"].shape[0] == 4
    jm, params, tm = disk_models(batch, "qa%tva", caption_type="lm")
    want = jm.apply({"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
                    parse_task("qa%tva"), True, False)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse("qa%tva"), True, False)
    np.testing.assert_allclose(float(got["qa_loss"]), float(want["qa_loss"]), rtol=TOL, atol=TOL)


def test_validate_qa_matches_jax(qa_dataset, monkeypatch, tmp_path):
    """The QA fixture through both packages' evaluation loaders (equal batches,
    one row a question), then ``validate_qa`` with the same weights: equal
    reports and dumps (ground truths, each group's predictions, the submitted
    file named by the flow); and the id fallback without the batch's answers."""
    from tests.test_torch_caption import _loaders, _read_dir, disk_models
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JTok
    from valor_tpu.eval.validate import validate_qa as jvalidate
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer as TTok
    from valor_tpu_torch.eval.validate import validate_qa

    jbatches, tbatches, _ = _loaders(qa_dataset, monkeypatch, "qa%tva", batch_size=6,
                                     flow_kw={"video_sample_num": 3})
    batch = jbatches[0]
    n_pairs = sum(len(v) for v in json.load(open(qa_dataset["val_txt"])).values())
    assert batch["question_prompt"].shape[0] == len(batch["answers"]) == n_pairs > 6
    jm, params, tm = disk_models(dict(batch, bert_tokens=batch["question_prompt"]), "qa%tva")
    answers = json.load(open(qa_dataset["val_txt"]))
    jtok, ttok = JTok(qa_dataset["vocab"]), TTok(qa_dataset["vocab"])
    kw = dict(caption_type="unimlm", max_len=4, beam_size=1, step=3, dset_name="fix")
    task = "qa%tva%tv"
    trep = validate_qa(tm, iter([dict(b) for b in tbatches]), tparse(task), ttok, answers,
                       result_dir=str(tmp_path / "t"), **kw)
    jrep = jvalidate(jm, params, iter([dict(b) for b in jbatches]), parse_task(task), jtok, answers,
                     result_dir=str(tmp_path / "j"), **kw)
    assert trep == jrep and set(trep) == {"accuracy", "tv_accuracy"}
    tdump, jdump = _read_dir(tmp_path / "t"), _read_dir(tmp_path / "j")
    assert tdump == jdump
    assert set(tdump) == {"step3_gt.json", "step3_tva_pred.json", "step3_tv_pred.json",
                          "step3_tva_pred_submited_fix.json"}
    assert len(tdump["step3_gt.json"]) == len(tdump["step3_tva_pred.json"]) == n_pairs
    assert [r["question_id"] for r in tdump["step3_tva_pred_submited_fix.json"]] == \
        [p["question_id"] for i in json.load(open(qa_dataset["val_ids"])) for p in answers[i]]
    # without the batch's answers: ground truths through tile_index -> id
    no_answers = [{k: v for k, v in b.items() if k != "answers"} for b in tbatches]
    fallback = {i: "x" for i in json.load(open(qa_dataset["val_ids"]))}
    rep = validate_qa(tm, iter(no_answers), tparse("qa%tva"), ttok, fallback, **kw)
    assert set(rep) == {"accuracy"}


def test_main_finetunes_and_validates_qa(qa_dataset, tmp_path, monkeypatch):
    """``cli.train`` on the QA fixture: two steps, one validation at 8 frames
    whose ``eval … @`` line carries ``accuracy``, one row a question in the
    dumps, best-checkpoint tracking on accuracy."""
    from tests.test_torch_caption import _read_dir
    from tests.test_torch_cli import TINY, _flow
    from valor_tpu_torch.cli.train import main

    monkeypatch.setenv("VALOR_BERT_VOCAB", qa_dataset["vocab"])
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "no_weights"))
    # the golden-file tests stub tensorboardX (SummaryWriter=object) for the rest of their process
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)
    out = tmp_path / "out"
    cfg = {**TINY, "learning_rate": 1e-3, "num_train_steps": 2, "valid_steps": 0,
           "output_dir": str(out), "max_generation_len": 3,
           "data_cfg": {"train": [_flow(qa_dataset, "train", "qa%tva", 4, n_workers=1)],
                        "val": [_flow(qa_dataset, "val", "qa%tva", 4, video_sample_num=3)]}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    trainer = main(["--config", str(path), "--device", "cpu"])
    assert [h[0] for h in trainer.history] == [1, 2]
    assert all(np.isfinite(h[2]["qa_loss"]) for h in trainer.history)
    log = (out / "log" / "train.log").read_text()
    line = next(x for x in log.splitlines() if "eval fix @ 2" in x)
    report = eval(line.split("eval fix @ 2: ")[1])  # noqa: S307 - the logged dict
    assert set(report) == {"accuracy"} and 0 <= report["accuracy"] <= 100
    n_pairs = sum(len(v) for v in json.load(open(qa_dataset["val_txt"])).values())
    dumps = _read_dir(out / "results_test_fix")
    assert len(dumps["step2_gt.json"]) == len(dumps["step2_tva_pred.json"]) == n_pairs
    assert "step2_tva_pred_submited_fix.json" in dumps
    assert trainer.best == {"fix/accuracy": report["accuracy"]}
    assert os.listdir(out / "ckpt") == ["step_2"]
