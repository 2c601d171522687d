"""Task prompts and pretraining validation of the PyTorch port against ``valor_tpu`` (CPU, fp32).

Tolerances, with their reasons:

  * prompt ids, batch injection and the QA splice exactly (host code);
  * a prompted ``pt`` loss and every parameter gradient 1e-4, the whole-model
    tolerance of the port's tests (fp32 on both sides, sums in another order);
  * ``validate_pt`` reports equal: token accuracies are counts of equal
    argmaxes, rounded to 2 decimals, and the recalls ranks.

The caption and MLM objectives mask tokens at random, and the two packages
draw other bits: ``monkeypatch`` hands both the same numpy-made mask
(tests/test_torch_train.py:_patch_masks).  JAX is imported inside the tests.
"""

import json
import sys

import numpy as np
import pytest
import torch

from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.data.prompts import CAPTION_PROMPT, CONTRA_PROMPT, MLM_PROMPTS, QA_PROMPT
from valor_tpu_torch.data.synthetic import WORDS, write_tokenizer_files
from valor_tpu_torch.models.bridge import params_from_jax, train_model

TOL = 1e-4
PT = "pt_contra%tva%tv_caption%tva%tv_mlm%tv"
PROMPT_WORDS = sorted(set(" ".join([CONTRA_PROMPT, CAPTION_PROMPT, QA_PROMPT,
                                    *MLM_PROMPTS.values()]).split()))


@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    """A WordPiece vocabulary and CLIP merges that hold every prompt word."""
    return write_tokenizer_files(str(tmp_path_factory.mktemp("tok")), list(WORDS) + PROMPT_WORDS)


def _tables(tok_files, txt_type, mm_type="bert_base_uncased"):
    from valor_tpu.data.prompts import PromptTable as JTable
    from valor_tpu.data.tokenizers.clip_bpe import ClipBPETokenizer as JClip
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JBert
    from valor_tpu_torch.data.prompts import PromptTable
    from valor_tpu_torch.data.tokenizers.clip_bpe import ClipBPETokenizer
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer

    kw = dict(txt_encoder_type=txt_type, multimodal_encoder_type=mm_type)
    j = JTable(JBert(tok_files["vocab"]), JClip(tok_files["merges"]), **kw)
    t = PromptTable(BertTokenizer(tok_files["vocab"]), ClipBPETokenizer(tok_files["merges"]), **kw)
    return j, t


@pytest.mark.parametrize("txt_type", ["clip_vit_base_16", "bert_base_uncased"])
@pytest.mark.parametrize("mm_type", ["bert_base_uncased", "clip_vit_base_16"])
def test_prompt_table_ids_match_jax(tok_files, txt_type, mm_type):
    """BERT ``[CLS] ids [SEP]`` or CLIP ``sot ids eot``, the contrastive prompt
    in the text encoder's tokenizer and the others in the fusion encoder's."""
    j, t = _tables(tok_files, txt_type, mm_type)
    for name in ("contra", "caption", "qa_body"):
        got, want = getattr(t, name)(), getattr(j, name)()
        assert got.dtype == want.dtype == np.int32 and got.shape[0] == 1
        np.testing.assert_array_equal(got, want)
    for g in ("tva", "tv", "ta", "va"):
        np.testing.assert_array_equal(t.mlm(g), j.mlm(g))
    contra = t.contra()[0].tolist()
    if txt_type.startswith("clip"):
        from valor_tpu_torch.data.tokenizers.clip_bpe import ClipBPETokenizer

        clip = ClipBPETokenizer(tok_files["merges"])
        assert contra[0] == clip.sot_token and contra[-1] == clip.eot_token
        assert contra[1:-1] == clip.encode(CONTRA_PROMPT)
    else:
        assert contra[0] == 101 and contra[-1] == 102 and 100 not in contra  # no [UNK]
    np.testing.assert_array_equal(t.qa_body()[0], t._encode(QA_PROMPT, mm_type)[0, 1:-1])


@pytest.mark.parametrize("task", ["pt_contra%tva%tv_caption%tva_mlm%tv%ta", "cap%tva", "ret%tva%tv",
                                  "qa%tva"])
def test_inject_matches_jax(tok_files, task):
    from valor_tpu.core.tasks import parse_task
    from valor_tpu_torch.data.prompts import maybe_prompt_table, prompted_collate

    j, t = _tables(tok_files, "clip_vit_base_16")
    rng = np.random.RandomState(0)
    q = np.zeros((3, 8), np.int32)
    q[:, 0] = 101
    q[:, 1:4] = rng.randint(106, 130, size=(3, 3))
    q[:, 4] = 102
    batch = {"bert_tokens": rng.randint(106, 130, size=(3, 6)).astype(np.int32), "question_prompt": q,
             "ids": ["x", "y", "z"]}
    got, want = t.inject(dict(batch), tparse(task)), j.inject(dict(batch), parse_task(task))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    spec = tparse(task)
    if spec.family == "qa":  # [CLS] + body + question[1:]
        body = t.qa_body()[0]
        np.testing.assert_array_equal(got["question_prompt"],
                                      np.concatenate([q[:, :1], np.tile(body, (3, 1)), q[:, 1:]], 1))
    else:
        assert ("prompt_tokens_contra" in got) == bool(spec.contra_groups or spec.family == "ret")
        assert ("prompt_tokens_caption" in got) == bool(spec.caption_groups)
        assert {k for k in got if k.startswith("prompt_tokens_mlm_")} == {
            f"prompt_tokens_mlm_{g}" for g in spec.mlm_groups}
    # the collate wrapper: a no-op without a table, the injection with one
    from valor_tpu_torch.core.config import ModelConfig

    collate = lambda items: dict(batch)  # noqa: E731
    assert prompted_collate(collate, maybe_prompt_table(ModelConfig(), (None, None)), spec) is collate
    assert prompted_collate(collate, t, spec)([]).keys() == got.keys()


# -- a prompted pretraining step ------------------------------------------------

def _port_model(cfg, params):
    """The port's training model with JAX's weights; with the BERT text tower
    the CLIP text tower, which JAX does not build, keeps a seeded init."""
    from tests.test_torch_models import _np, torch_config
    from valor_tpu_torch.models.bridge import init_params

    sd = init_params(torch_config(cfg), seed=0, device="cpu")
    sd.update(params_from_jax(_np(params)))
    return train_model(torch_config(cfg), sd, "cpu")


def _pattern(shape, prob):
    pick = np.random.RandomState(7).rand(*shape) < prob
    pick[:, 0], pick[:, 1] = False, True
    return pick


def _patch_masks(monkeypatch):
    """Both packages' ``mask_tokens`` replaced by one numpy-made pattern at the
    rate each call asks for, on the non-pad tokens (traceable under ``jax.jit``)."""
    import jax.numpy as jnp

    import valor_tpu.models.valor as jv
    import valor_tpu_torch.models.valor as tv

    def jax_mask(rng, tokens, prob, *a):
        pick = jnp.asarray(_pattern(tokens.shape, prob)) & (tokens != 0)
        return jnp.where(pick, 103, tokens), jnp.where(pick, tokens, -1)

    def torch_mask(gen, tokens, prob, *a):
        pick = torch.from_numpy(_pattern(tuple(tokens.shape), prob)).to(tokens.device) & (tokens != 0)
        return torch.where(pick, 103, tokens), torch.where(pick, tokens, -1)

    monkeypatch.setattr(jv, "mask_tokens", jax_mask)
    monkeypatch.setattr(tv, "mask_tokens", torch_mask)


def _batch(tok_files, seed=0, b=4, txt_type="bert_base_uncased"):
    from tests.test_torch_models import tiny_batch

    _, t = _tables(tok_files, txt_type)
    batch = tiny_batch(seed=seed, b=b)
    return t.inject(batch, tparse(PT))


@pytest.mark.parametrize("txt_type", ["bert_base_uncased", "clip_vit_tiny"])
def test_prompted_pt_loss_and_every_gradient_match_jax(tok_files, txt_type, monkeypatch):
    """``forward_pt`` with every prompt array of ``pt_contra..._caption..._mlm``,
    the contrastive prompt through the BERT or the CLIP text tower: losses and
    every gradient within 1e-4 of JAX's, with the masks patched."""
    import jax
    import jax.numpy as jnp

    from tests.conftest import tiny_model_config
    from tests.test_torch_models import _np
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu_torch.ops.layers import RNGStreams, rng_scope

    _patch_masks(monkeypatch)
    cfg = tiny_model_config(dropout=0.0, use_task_prompt=True, txt_encoder_type=txt_type,
                            init_clip_head=txt_type.startswith("clip"))
    batch = _batch(tok_files)
    assert {"prompt_tokens_contra", "prompt_tokens_caption", "prompt_tokens_mlm_tv"} <= set(batch)
    jm = JaxVALOR(cfg)
    task = parse_task(PT)
    params = jax.jit(lambda r, b: jm.init(r, b, task, True, True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, batch)["params"]

    def loss(p):
        out = jm.apply({"params": p}, batch, task, True, True, rngs={"mask": jax.random.PRNGKey(2)})
        return sum(jnp.asarray(v, jnp.float32) for v in out.values()), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    plain = jm.apply({"params": params}, {k: v for k, v in batch.items() if not k.startswith("prompt")},
                     task, True, True, rngs={"mask": jax.random.PRNGKey(2)})
    tm = _port_model(cfg, params)
    with rng_scope(RNGStreams(0)):
        out = tm({k: torch.from_numpy(v) for k, v in batch.items()}, tparse(PT))
    sum(out.values()).backward()
    assert set(out) == set(ref) == {"contra_loss", "caption_loss", "mlm_loss"}
    for k in ref:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]), rtol=TOL, atol=TOL, err_msg=k)
        assert abs(float(ref[k]) - float(plain[k])) > 1e-4, k  # the prompts reach every objective
    ref_g = params_from_jax(_np(grads))
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        want = ref_g[name] if name in ref_g else torch.zeros_like(p)  # a tower JAX never built
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL, err_msg=name)
    assert float(tm.multimodal_encoder.embeddings.prompt_embedding.grad.abs().max()) > 0


# -- validate_pt -----------------------------------------------------------------

@pytest.mark.parametrize("prompts", [False, True])
@pytest.mark.parametrize("contra_type", ["fine", "coarse"])
def test_validate_pt_reports_match_jax(tok_files, monkeypatch, prompts, contra_type):
    """The tiny batches of tests/test_qa_scst.py's proxy-metric test (two of
    four items, with ids): per-group caption and MLM accuracies, the
    aggregates and a recall per contrastive group, equal to JAX's with the
    masks patched."""
    import jax

    from tests.conftest import tiny_model_config
    from tests.test_torch_models import tiny_batch
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.eval.validate import validate_pt as jvalidate
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu.train.step import make_eval_step
    from valor_tpu_torch.eval.validate import validate_pt
    from valor_tpu_torch.train.step import eval_step

    _patch_masks(monkeypatch)
    cfg = tiny_model_config(contra_type=contra_type, use_task_prompt=prompts,
                            txt_encoder_type="bert_base_uncased", init_clip_head=False)
    batches = [_batch(tok_files, seed=s) if prompts else tiny_batch(seed=s, b=4) for s in (30, 31)]
    for i, b in enumerate(batches):
        b["ids"] = [f"i{4 * i + k}" for k in range(4)]
        b["ids_txt"] = list(b["ids"])
    jm = JaxVALOR(cfg)
    task = parse_task(PT)
    arrays = {k: v for k, v in batches[0].items() if isinstance(v, np.ndarray)}
    params = jax.jit(lambda r, b: jm.init(r, b, task, True, True))(
        {"params": jax.random.PRNGKey(3), "mask": jax.random.PRNGKey(1)}, arrays)["params"]
    want = jvalidate(jm, params, make_eval_step(jm), [dict(b) for b in batches], task, contra_type)
    tm = _port_model(cfg, params)
    got = validate_pt(tm, eval_step, [dict(b) for b in batches], tparse(PT), contra_type)
    assert got == want
    assert set(got) == {"caption_acc_tva", "caption_acc_tv", "caption_token_acc", "mlm_acc_tv",
                        "mlm_token_acc", "contra_recall_tva", "contra_recall_tv"}
    assert tm.training  # eval_step restores the training mode


# -- cli.train with a pt validation flow and task prompts ------------------------

def test_main_pretrains_with_prompts_and_validates_pt(tmp_path, monkeypatch):
    """``cli.train`` on the retrieval fixture with ``use_task_prompt``: the
    batches of both packages' loaders carry the same prompt arrays, the
    training batches reach the step with them, and the ``pt`` evaluation flow
    logs the ``validate_pt`` report keys."""
    import valor_tpu.cli.build as JB
    from tests.test_torch_cli import TINY, _flow
    from valor_tpu.core.config import load_config as jload
    from valor_tpu.data import native
    from valor_tpu_torch.cli import build as TB
    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.core.config import load_config as tload
    from valor_tpu_torch.data.synthetic import write_retrieval_dataset
    from valor_tpu_torch.train import trainer as T

    data = write_retrieval_dataset(str(tmp_path / "data"), n_train=8, n_val=6, n_frames=6,
                                   frame_size=(64, 48), wav_seconds=1.0, captions_per_train_id=3,
                                   workers=2)
    monkeypatch.setattr(native, "available", lambda: False)  # the JAX mapper's PIL branch
    monkeypatch.setattr(JB, "DEFAULT_BERT_VOCAB", data["vocab"])
    monkeypatch.setenv("VALOR_BERT_VOCAB", data["vocab"])
    monkeypatch.setenv("VALOR_CLIP_BPE", data["merges"])
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "no_weights"))
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)
    task = "pt_contra%tva%tv_caption%tva%tv"
    cfg = {**TINY, "use_task_prompt": True, "learning_rate": 1e-3, "num_train_steps": 2,
           "valid_steps": 0, "output_dir": str(tmp_path / "out"),
           "data_cfg": {"train": [_flow(data, "train", task, 4)], "val": [_flow(data, "val", task, 4)]}}
    (_, jloader, _), = JB.build_val_loaders(jload(None, dict(cfg)), JB.build_tokenizers(jload(None, dict(cfg)).model))
    (_, tloader, _), = TB.build_val_loaders(tload(None, dict(cfg)), TB.build_tokenizers(tload(None, dict(cfg)).model))
    jb, tb = next(iter(jloader)), next(iter(tloader))
    assert {"prompt_tokens_contra", "prompt_tokens_caption"} <= set(tb)
    for k in jb:
        if k.startswith("prompt_tokens"):
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)

    seen = []
    step0 = T.train_step

    def spy(state, batch, *a, **kw):
        seen.append(sorted(k for k in batch if k.startswith("prompt_tokens")))
        return step0(state, batch, *a, **kw)

    monkeypatch.setattr(T, "train_step", spy)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    trainer = main(["--config", str(tmp_path / "config.json"), "--device", "cpu"])
    assert seen == [["prompt_tokens_caption", "prompt_tokens_contra"]] * 2
    assert all(np.isfinite(v) for h in trainer.history for v in h[2].values())
    log = (tmp_path / "out" / "log" / "train.log").read_text()
    line = next(x for x in log.splitlines() if "eval fix @ 2" in x)
    report = eval(line.split("eval fix @ 2: ")[1])  # noqa: S307 - the logged dict
    assert set(report) == {"caption_acc_tva", "caption_acc_tv", "caption_token_acc",
                           "contra_recall_tva", "contra_recall_tv"}
    assert all(np.isfinite(v) for v in report.values())
    assert trainer.best == {}  # no metric of a pt report is tracked
