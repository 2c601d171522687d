"""Caption finetuning and validation of the PyTorch port against ``valor_tpu`` (CPU, fp32).

Tolerances, with their reasons:

  * ``forward_cap``'s loss and every parameter gradient 1e-4, the whole-model
    tolerance of the port's tests (fp32 on both sides, sums in another order);
  * the caption metrics (``eval/ptb.py``, ``eval/cococaption.py``,
    ``eval/caption_metrics.py``) equal, since the port keeps copies of the
    same Python; 1e-12 where a float sum may run in another order;
  * the ``MeteorJar``/``SpiceJar`` protocols exactly, through the fake pipes
    of tests/test_metrics.py;
  * from a disk fixture: the first batch's loss within 1e-4; ``validate_cap``
    with the same weights: reports and dumped JSON equal (the generated
    sequences are equal token for token); ``cli.train`` end to end.

The unimlm caption objective masks tokens at random, and the two packages draw
other bits: ``monkeypatch`` hands both the same numpy-made mask at the masking
rate each forward asks for (0.6 for captions).

JAX is imported inside the parity tests, so that the card test (marked
``cuda``) also runs where only the port is installed.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.data.synthetic import write_caption_dataset
from valor_tpu_torch.models.bridge import params_from_jax, train_model
from valor_tpu_torch.ops.layers import RNGStreams, rng_scope

TOL = 1e-4
CAP = "cap%tva%tv%ta"


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jax_params():
    return tiny_jax_params()


def tiny_jax_params():
    """(config, JAX params) of the tiny model: caption_type lm, dropout 0; the
    pretraining task's init reaches every head."""
    import jax

    from tests.conftest import tiny_model_config
    from tests.test_torch_models import PT_TASK, _np, tiny_batch, torch_config
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR

    cfg = tiny_model_config(dropout=0.0, caption_type="lm")
    jm = JaxVALOR(cfg)
    params = jax.jit(lambda r, b: jm.init(r, b, parse_task(PT_TASK), True, True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, tiny_batch())["params"]
    return cfg, params


def patch_masks(monkeypatch, probs):
    """Both packages' ``mask_tokens`` (in ``models/valor.py``) replaced by one
    numpy mask drawn at the rate each call asks for; ``probs`` collects the
    rates (JAX's, then the port's)."""
    import jax.numpy as jnp

    import valor_tpu.models.valor as jv
    import valor_tpu_torch.models.valor as tv

    def fixed(tokens, prob, seed=7):
        rng = np.random.RandomState(seed)
        tok = np.asarray(tokens)
        pick = (rng.rand(*tok.shape) < prob) & (tok != 0)
        pick[:, 0] = False
        pick[np.arange(len(tok)), 1] = True
        return np.where(pick, 103, tok).astype(tok.dtype), np.where(pick, tok, -1).astype(tok.dtype)

    def jax_mask(rng, tokens, prob, *a):
        probs.append(("jax", prob))
        return tuple(jnp.asarray(x) for x in fixed(tokens, prob))

    def torch_mask(gen, tokens, prob, *a):
        probs.append(("torch", prob))
        return tuple(torch.from_numpy(x) for x in fixed(tokens.numpy(), prob))

    monkeypatch.setattr(jv, "mask_tokens", jax_mask)
    monkeypatch.setattr(tv, "mask_tokens", torch_mask)


def losses_and_grads(cfg, params, batch, task):
    """(JAX losses, JAX gradients as the port's state dict, port losses, port
    model with its gradients) of one forward of ``task`` on ``batch``."""
    import jax

    from tests.test_torch_models import _np, torch_config
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR

    jm = JaxVALOR(cfg)
    spec = parse_task(task)

    def loss(p):
        out = jm.apply({"params": p}, batch, spec, True, True, rngs={"mask": jax.random.PRNGKey(2)})
        return sum(out.values()), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu")
    with rng_scope(RNGStreams(0)):
        out = tm({k: torch.as_tensor(v) for k, v in batch.items()}, tparse(task))
    sum(out.values()).backward()
    return ref, params_from_jax(_np(grads)), out, tm


def check_losses_and_grads(ref, ref_g, out, tm):
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k].detach(), ref[k])
    assert set(ref_g) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got.numpy(), ref_g[name].numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("caption_type", ["lm", "unimlm"])
def test_forward_cap_loss_and_every_gradient(caption_type, monkeypatch, jax_params):
    from tests.test_torch_models import tiny_batch

    cfg, params = jax_params
    cfg = dataclasses.replace(cfg, caption_type=caption_type)
    probs = []
    if caption_type == "unimlm":
        patch_masks(monkeypatch, probs)
    ref, ref_g, out, tm = losses_and_grads(cfg, params, tiny_batch(seed=21), CAP)
    assert set(out) == {"caption_loss"} and float(out["caption_loss"]) > 0
    check_losses_and_grads(ref, ref_g, out, tm)
    assert probs == ([("jax", 0.6), ("torch", 0.6)] if caption_type == "unimlm" else [])


def test_forward_cap_without_loss_gives_the_fusion_inputs(jax_params):
    from tests.test_torch_models import _np, tiny_batch, torch_config
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR

    cfg, params = jax_params
    batch = tiny_batch(seed=22)
    jm = JaxVALOR(cfg)
    ref = jm.apply({"params": params}, batch, parse_task("cap%tv"), False, False)
    tm = train_model(torch_config(cfg), params_from_jax(_np(params)), "cpu").eval()
    with torch.no_grad():
        out = tm({k: torch.as_tensor(v) for k, v in batch.items()}, tparse("cap%tv"), False, False)
    assert out["audio_input"] is None and ref["audio_input"] is None
    _close(out["video_input"], ref["video_input"])


@pytest.mark.cuda
def test_cap_step_and_waveform_decodes_card_vs_cpu():
    """The tiny ``cap%tva`` step on the card against the CPU (losses and every
    gradient within 1e-4), and greedy and beam-3 captions (and answers) decoded
    from clip-span waveforms through the device fbank, token for token
    (``chip_smoke.py``'s check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    out = chip_smoke.phase_cap_qa_card_vs_cpu("cuda")
    assert out["steps"]["cap%tva"]["max_loss_diff"] <= 1e-4
    assert set(out["sequences"]) == {"caption_greedy", "caption_beam3", "qa_greedy"}


# -- the caption metrics ---------------------------------------------------------

def _corpus(seed=0, n=12):
    """Captions with punctuation, contractions, case and brackets, as models and
    annotators write them."""
    rng = np.random.RandomState(seed)
    words = ["a", "man", "is", "playing", "guitar", "the", "dog's", "runs", "on", "grass", "it's",
             "A", "Cat", "(sits)", "mat.", "car,", "drives", "down", "road!", "kids", "don't",
             "dance", "on", "stage?", "\"hello\"", "well-known", "$5", "people;", "talk"]

    def sent():
        return " ".join(rng.choice(words, size=rng.randint(3, 12)))

    hyps = {f"v{i}": sent() for i in range(n)}
    refs = {f"v{i}": [sent() for _ in range(rng.randint(1, 5))] for i in range(n)}
    return hyps, refs


def test_metric_copies_match_jax():
    from valor_tpu.eval import caption_metrics as JC
    from valor_tpu.eval import cococaption as JCC
    from valor_tpu.eval import ptb as JP
    from valor_tpu_torch.eval import caption_metrics as TC
    from valor_tpu_torch.eval import cococaption as TCC
    from valor_tpu_torch.eval import ptb as TP

    hyps, refs = _corpus()
    sents = list(hyps.values()) + [r for rs in refs.values() for r in rs]
    assert [TP.ptb_word_tokenize(x) for x in sents] == [JP.ptb_word_tokenize(x) for x in sents]
    assert TP.ptb_tokenize(refs) == JP.ptb_tokenize(refs)
    nh = {k: TP.ptb_normalize(v) for k, v in hyps.items()}
    nr = TP.ptb_tokenize(refs)
    assert nh == {k: JP.ptb_normalize(v) for k, v in hyps.items()}
    h_tok = [nh[k].split() for k in sorted(hyps)]
    r_tok = [[r.split() for r in nr[k]] for k in sorted(hyps)]
    np.testing.assert_allclose(TC.bleu_corpus(h_tok, r_tok), JC.bleu_corpus(h_tok, r_tok), rtol=1e-12)
    for h, r in zip(h_tok, r_tok):
        assert TC.bleu_sentence(h, r) == pytest.approx(JC.bleu_sentence(h, r), rel=1e-12, abs=1e-12)
    assert TC.rouge_l(h_tok, r_tok) == pytest.approx(JC.rouge_l(h_tok, r_tok), rel=1e-12)
    # document frequencies fitted on the evaluated set, and on another corpus
    np.testing.assert_allclose(TC.CiderScorer().score(h_tok, r_tok),
                               JC.CiderScorer().score(h_tok, r_tok), rtol=1e-12, atol=1e-12)
    other = [[x.split() for x in rs] for rs in _corpus(seed=1)[1].values()]
    np.testing.assert_allclose(TC.CiderScorer().fit_df(other).score(h_tok, r_tok),
                               JC.CiderScorer().fit_df(other).score(h_tok, r_tok), rtol=1e-12, atol=1e-12)
    assert TCC.porter_stem("running") == JCC.porter_stem("running") == "run"
    assert TCC.meteor_lite(nh, nr) == pytest.approx(JCC.meteor_lite(nh, nr), rel=1e-12)
    report = TC.caption_eval(hyps, refs)
    assert report == JC.caption_eval(hyps, refs) and report["CIDEr"] > 0
    assert TC.caption_eval(nh, nr, tokenize=False) == JC.caption_eval(nh, nr, tokenize=False)


def test_meteor_on_the_frozen_fixture_matches_jax():
    """tests/data/meteor_calibration.json (tests/test_metrics.py's fixture):
    every segment scores the same in both packages."""
    from valor_tpu.eval.cococaption import _meteor_segment as jseg
    from valor_tpu_torch.eval.cococaption import _meteor_segment as tseg

    path = os.path.join(os.path.dirname(__file__), "data", "meteor_calibration.json")
    pairs = json.load(open(path))
    assert len(pairs) == 50
    for item in pairs:
        for r in item["refs"]:
            assert tseg(item["hyp"].split(), r.split()) == jseg(item["hyp"].split(), r.split())


class _FakeMeteorPipe:
    """Speaks the METEOR-1.5 -stdio protocol from the jar's side (as in
    tests/test_metrics.py)."""

    def __init__(self):
        self.received, self._out = [], []

    def write(self, line):
        line = line.strip()
        self.received.append(line)
        if line.startswith("SCORE |||"):
            self._out.append(f"stats_{len(self.received)}_{len(line.split('|||')) - 1}")
        elif line.startswith("EVAL |||"):
            self._out.extend(["0.2500"] * len(line.split("|||")[1:]) + ["0.3125"])

    def close(self):
        pass

    def readline(self):
        return self._out.pop(0) + "\n"


def _fake_java(monkeypatch, tmp_path, cc):
    for env, name in ((cc.METEOR_JAR_ENV, "meteor-1.5.jar"), (cc.SPICE_JAR_ENV, "spice-1.0.jar")):
        (tmp_path / name).write_bytes(b"")
        monkeypatch.setenv(env, str(tmp_path / name))
    monkeypatch.setattr(cc, "java_available", lambda: True)
    pipe, seen = _FakeMeteorPipe(), {}

    class P:
        def __init__(self, cmd, **kw):
            pipe.cmd = cmd
            self.stdin = self.stdout = pipe

        def kill(self):
            pass

    def fake_call(cmd, cwd=None):
        seen["cmd"] = cmd
        payload = json.load(open(cmd[4]))  # java -jar -Xmx8G <jar> <input>
        seen["payload"] = payload
        json.dump([{"image_id": p["image_id"], "scores": {"All": {"f": 0.1 * (i + 1), "p": 0, "r": 0}}}
                   for i, p in enumerate(payload)], open(cmd[cmd.index("-out") + 1], "w"))

    monkeypatch.setattr(cc.subprocess, "Popen", P)
    monkeypatch.setattr(cc.subprocess, "check_call", fake_call)
    return pipe, seen


def test_meteor_and_spice_jar_protocols(monkeypatch, tmp_path):
    """The protocol exchanges of tests/test_metrics.py's TestMeteorJarProtocol,
    TestSpiceJarProtocol and TestCaptionEvalAllColumns, through the port's copy."""
    from valor_tpu_torch.eval import caption_metrics as TC
    from valor_tpu_torch.eval import cococaption as cc

    pipe, seen = _fake_java(monkeypatch, tmp_path, cc)
    hyps = {"a": "a cat", "b": "the dog"}
    refs = {"a": ["a cat sits", "a feline"], "b": ["the dog runs"]}
    corpus, seg = cc.MeteorJar().score(hyps, refs)
    assert corpus == 0.3125 and seg == {"a": 0.25, "b": 0.25}
    score_lines = [line for line in pipe.received if line.startswith("SCORE")]
    assert score_lines == ["SCORE ||| a cat sits ||| a feline ||| a cat", "SCORE ||| the dog runs ||| the dog"]
    (eval_line,) = [line for line in pipe.received if line.startswith("EVAL")]
    assert eval_line.split(" ||| ")[1:] == ["stats_1_3", "stats_2_2"] and "-stdio" in pipe.cmd
    cc.MeteorJar().score({"a": "x ||| y"}, {"a": ["r"]})
    assert "SCORE ||| r ||| x y" in pipe.received

    corpus, seg = cc.SpiceJar().score({"a": "a cat", "b": "the dog"},
                                      {"a": ["a cat sits"], "b": ["the dog runs", "a dog"]})
    np.testing.assert_allclose([corpus, seg["a"], seg["b"]], [0.15, 0.1, 0.2])
    assert seen["payload"] == [{"image_id": "a", "test": "a cat", "refs": ["a cat sits"]},
                               {"image_id": "b", "test": "the dog", "refs": ["the dog runs", "a dog"]}]
    assert "-cache" in seen["cmd"] and "-subset" in seen["cmd"]

    report = TC.caption_eval({"a": "a cat sits", "b": "the dog runs"},
                             {"a": ["a cat sits on the mat"], "b": ["the dog runs fast"]})
    assert set(report) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR", "SPICE"}
    assert report["METEOR"] == 0.3125


def test_jars_stay_off_without_java(monkeypatch, tmp_path):
    from valor_tpu_torch.eval import caption_metrics as TC
    from valor_tpu_torch.eval import cococaption as cc

    monkeypatch.setenv(cc.METEOR_JAR_ENV, str(tmp_path / "absent.jar"))
    report = TC.caption_eval({"a": "a cat sits"}, {"a": ["a cat sits on the mat"]})
    assert "SPICE" not in report and "METEOR" in report  # meteor_lite stands in


# -- validate_cap and cli.train from disk --------------------------------------

@pytest.fixture(scope="module")
def cap_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("msrvtt_cap")
    return write_caption_dataset(str(root), n_train=8, n_val=6, captions_per_id=3, n_frames=6,
                                 frame_size=(64, 48), wav_seconds=1.0, workers=2)


def _loaders(dataset, monkeypatch, task, batch_size=4, flow_kw=None):
    """The evaluation flow of ``task`` on ``dataset`` through both packages'
    ``cli/build.py``: (JAX batches, port batches, port task spec)."""
    import valor_tpu.cli.build as JB
    from valor_tpu.core.config import load_config as jload
    from tests.test_torch_cli import TINY, _flow
    from valor_tpu.data import native
    from valor_tpu_torch.cli import build as TB
    from valor_tpu_torch.core.config import load_config as tload

    monkeypatch.setattr(native, "available", lambda: False)  # the JAX mapper's PIL branch
    monkeypatch.setattr(JB, "DEFAULT_BERT_VOCAB", dataset["vocab"])
    monkeypatch.setenv("VALOR_BERT_VOCAB", dataset["vocab"])
    raw = dict(TINY, data_cfg={"val": [_flow(dataset, "val", task, batch_size, **(flow_kw or {}))]})
    jcfg, tcfg = jload(None, dict(raw)), tload(None, dict(raw))
    (_, jloader, _), = JB.build_val_loaders(jcfg, JB.build_tokenizers(jcfg.model))
    (_, tloader, spec), = TB.build_val_loaders(tcfg, TB.build_tokenizers(tcfg.model))
    jb, tb = list(jloader), list(tloader)
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    return jb, tb, spec


def disk_models(batch, task, seed=0, **cfg_kw):
    """(JAX model, params, port model) of the disk fixtures' tiny config with one
    set of weights, the JAX init's where it reaches (``kernel_scale`` 8, so the
    captions follow the media) and the port's seeded init elsewhere."""
    import jax
    import jax.numpy as jnp

    from tests.conftest import tiny_model_config
    from tests.test_torch_cli import TINY
    from tests.test_torch_models import _np, torch_config
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu_torch.models.bridge import init_params, load_model

    cfg = tiny_model_config(**{**TINY, **cfg_kw})
    jm = JaxVALOR(cfg)
    params = jax.jit(lambda r, b: jm.init(r, b, parse_task(task), True, True))(
        {"params": jax.random.PRNGKey(seed), "mask": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)})["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 8.0 if path[-1].key == "kernel" else x, params)
    sd = init_params(torch_config(cfg), seed=seed, device="cpu")
    sd.update(params_from_jax(_np(params)))
    return jm, params, load_model(torch_config(cfg), sd, "cpu")


def _caption_batch(val_batch):
    """The evaluation batch's media with each id's first reference as its caption."""
    first = np.cumsum([0] + val_batch["sample_num"][:-1])
    out = {k: v for k, v in val_batch.items() if isinstance(v, np.ndarray)}
    out["bert_tokens"] = val_batch["bert_tokens"][first]
    return out


def _read_dir(path):
    return {f: json.load(open(os.path.join(path, f))) for f in sorted(os.listdir(path))}


def test_first_loss_and_validate_cap_match_jax(cap_dataset, monkeypatch, tmp_path):
    """The caption fixture through both packages' evaluation loaders (equal
    batches; waveforms through each device fbank): the first batch's
    ``cap%tva`` loss within 1e-4, and ``validate_cap``'s reports and dumps equal
    over groups tva, tv and ta, and in each ``submit_format``."""
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JTok
    from valor_tpu.eval.validate import validate_cap as jvalidate
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer as TTok
    from valor_tpu_torch.eval.validate import validate_cap

    jbatches, tbatches, _ = _loaders(cap_dataset, monkeypatch, "cap%tva", batch_size=6)
    first = _caption_batch(jbatches[0])
    assert first["audio_waveforms"].shape[1] == 2 and first["bert_tokens"].shape[0] == 6
    jm, params, tm = disk_models(first, "cap%tva", caption_type="lm")
    want = jm.apply({"params": params}, first, parse_task("cap%tva"), True, False)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in first.items()}, tparse("cap%tva"), True, False)
    _close(got["caption_loss"], want["caption_loss"])

    ann = json.load(open(cap_dataset["val_txt"]))
    jm, params, tm = disk_models(first, "cap%tva")
    jtok, ttok = JTok(cap_dataset["vocab"]), TTok(cap_dataset["vocab"])
    for fmt in (None, "coco", "nocaps", "vatex"):
        if fmt in ("coco", "nocaps"):  # numeric image ids
            tb = [dict(b, ids=[f"coco_{i}" for i in range(len(b["ids"]))]) for b in tbatches]
            jb = [dict(b, ids=[f"coco_{i}" for i in range(len(b["ids"]))]) for b in jbatches]
            if fmt == "nocaps":
                tb = [dict(b, ids=[str(i) for i in range(len(b["ids"]))]) for b in tb]
                jb = [dict(b, ids=[str(i) for i in range(len(b["ids"]))]) for b in jb]
        else:
            tb, jb = [dict(b) for b in tbatches], [dict(b) for b in jbatches]
        kw = dict(caption_type="unimlm", max_len=5, beam_size=3, step=7, submit_format=fmt)
        trep = validate_cap(tm, iter(tb), tparse("cap%tva%tv%ta"), ttok, ann,
                            result_dir=str(tmp_path / f"t{fmt}"), **kw)
        jrep = jvalidate(jm, params, iter(jb), parse_task("cap%tva%tv%ta"), jtok, ann,
                         result_dir=str(tmp_path / f"j{fmt}"), **kw)
        assert trep == jrep
        tdump, jdump = _read_dir(tmp_path / f"t{fmt}"), _read_dir(tmp_path / f"j{fmt}")
        assert tdump == jdump
        if fmt is None:
            assert {"CIDEr", "Bleu_4", "METEOR", "ROUGE_L", "tv_CIDEr", "ta_CIDEr"} <= set(trep)
            assert set(tdump) == {"step_7_tva.json", "step_7_tv.json", "step_7_ta.json"}
            assert len(tdump["step_7_tva.json"]) == 6
            assert len({c["caption"] for c in tdump["step_7_tva.json"]}) > 1  # captions follow the media
        else:
            assert trep == {} and set(tdump) == {"submission.json"}


def test_main_finetunes_and_validates_captions(cap_dataset, tmp_path, monkeypatch):
    """``cli.train`` on the caption fixture: two steps, one validation whose
    ``eval … @`` line carries the report keys of the JAX ``validate_cap``, a
    step dump of every evaluation id, and best-checkpoint tracking on CIDEr."""
    from tests.test_torch_cli import TINY, _flow
    from valor_tpu_torch.cli.train import main

    monkeypatch.setenv("VALOR_BERT_VOCAB", cap_dataset["vocab"])
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "no_weights"))
    # the golden-file tests stub tensorboardX (SummaryWriter=object) for the rest of their process
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)
    out = tmp_path / "out"
    cfg = {**TINY, "learning_rate": 1e-3, "num_train_steps": 2, "valid_steps": 0,
           "output_dir": str(out), "beam_size": 2,
           "data_cfg": {"train": [_flow(cap_dataset, "train", "cap%tva", 4)],
                        "val": [_flow(cap_dataset, "val", "cap%tva", 4)]}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    trainer = main(["--config", str(path), "--device", "cpu"])
    assert [h[0] for h in trainer.history] == [1, 2]
    assert all(np.isfinite(h[2]["caption_loss"]) for h in trainer.history)
    log = (out / "log" / "train.log").read_text()
    line = next(x for x in log.splitlines() if "eval fix @ 2" in x)
    report = eval(line.split("eval fix @ 2: ")[1])  # noqa: S307 - the logged dict
    assert set(report) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr", "METEOR"}
    assert all(np.isfinite(v) for v in report.values())
    dump = json.load(open(out / "results_test_fix" / "step_2_tva.json"))
    assert len(dump) == 6
    assert trainer.best == {"fix/CIDEr": report["CIDEr"]}
