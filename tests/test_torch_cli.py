"""``valor_tpu_torch.cli.train`` end to end on an on-disk fixture (CPU), and the
retrieval slice from disk against ``valor_tpu``.

The fixture is ``data/synthetic.py:write_retrieval_dataset`` at a tiny size
(JPEG frame folders, 22050 Hz WAVs with one id missing its audio, caption
files, a WordPiece vocabulary and CLIP merges); the model is the tiny config
with the BERT text tower (the tiny CLIP text tower's 512-token vocabulary has
no room for BPE merges).  Tolerances: the first batch's ``ret%tva%tv`` loss
1e-4 (the whole-model tolerance of the port's tests), batches exactly.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import tiny_model_config
from tests.test_torch_models import _np, torch_config
from valor_tpu_torch.data.synthetic import write_retrieval_dataset

TOL = 1e-4
RET = "ret%tva%tv"
TINY = dict(
    video_encoder_type="clip_vit_tiny", txt_encoder_type="bert_base_uncased", init_clip_head=False,
    video_resolution=32, audio_melbins=16, audio_target_length=32, audio_patch_size=16,
    fusion_hidden=32, fusion_layers=2, fusion_heads=2, fusion_intermediate=64, fusion_vocab=512,
    audio_hidden=32, audio_layers=2, audio_heads=2, audio_intermediate=64, contra_dim=16,
    dtype="float32", dropout=0.0, max_generation_len=4,
)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("msrvtt")
    return write_retrieval_dataset(str(root), n_train=8, n_val=6, n_frames=6, frame_size=(64, 48),
                                   wav_seconds=1.0, captions_per_train_id=3, workers=2)


def _flow(p, split, task, batch, **kw):
    ds = {"name": "fix", "ids_path": p[f"{split}_ids"], "txt": p[f"{split}_txt"], "video": p["frames"],
          "audio": p["audio"], "datatype": "video", "video_transforms": "crop_flip"}
    flow = {"task": task, "batch_size": batch, "video_sample_num": 2, "audio_sample_num": 2,
            "max_txt_len": 6, "n_workers": 2, **kw}
    return {"datasets": [ds], **flow} if split == "train" else {**ds, **flow}


@pytest.fixture
def config(dataset, tmp_path, monkeypatch):
    """Write a config (``extra`` keys and ``train`` flows overridable) and return its path."""
    monkeypatch.setenv("VALOR_BERT_VOCAB", dataset["vocab"])
    monkeypatch.setenv("VALOR_CLIP_BPE", dataset["merges"])
    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "no_weights"))
    # the golden-file tests stub tensorboardX (SummaryWriter=object) for the rest of their process
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)

    def write(name="config.json", train=None, val=None, **extra):
        cfg = {**TINY, "learning_rate": 1e-3, "num_train_steps": 2, "valid_steps": 0,
               "first_eval": False, "output_dir": str(tmp_path / "out"), **extra}
        cfg["data_cfg"] = {"train": train or [_flow(dataset, "train", RET, 4)],
                           "val": val if val is not None else [_flow(dataset, "val", RET, 4)]}
        path = tmp_path / name
        path.write_text(json.dumps(cfg))
        return str(path)

    return write


def _main(*argv):
    from valor_tpu_torch.cli.train import main

    return main([*argv, "--device", "cpu"])


# -- the slice against valor_tpu -----------------------------------------------
def test_first_batch_loss_and_report_match_jax(dataset, monkeypatch):
    """The fixture through both packages' evaluation loaders: equal batches; the
    first batch's ret%tva%tv loss (waveforms through each device fbank) within
    1e-4; equal retrieval reports over the whole evaluation set."""
    import valor_tpu.cli.build as JB
    from valor_tpu.core.config import load_config as jload
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.data import native
    from valor_tpu.eval.validate import validate_ret as jvalidate
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu.train.step import make_eval_step
    from valor_tpu_torch.cli import build as TB
    from valor_tpu_torch.core.config import load_config as tload
    from valor_tpu_torch.eval.validate import validate_ret
    from valor_tpu_torch.models.bridge import init_params, load_model, params_from_jax
    from valor_tpu_torch.train.step import eval_step

    monkeypatch.setattr(native, "available", lambda: False)  # the JAX mapper's PIL branch
    monkeypatch.setattr(JB, "DEFAULT_BERT_VOCAB", dataset["vocab"])
    monkeypatch.setenv("VALOR_BERT_VOCAB", dataset["vocab"])
    raw = dict(TINY, data_cfg={"val": [_flow(dataset, "val", RET, 4)]})
    jcfg, tcfg = jload(None, dict(raw)), tload(None, dict(raw))
    (_, jloader, _), = JB.build_val_loaders(jcfg, JB.build_tokenizers(jcfg.model))
    (_, tloader, spec), = TB.build_val_loaders(tcfg, TB.build_tokenizers(tcfg.model))
    jbatches, tbatches = list(jloader), list(tloader)
    assert len(jbatches) == len(tbatches) == 2
    for jb, tb in zip(jbatches, tbatches):
        assert jb.keys() == tb.keys()
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
            else:
                assert jb[k] == tb[k], k
    first, second = ({k: v for k, v in b.items() if isinstance(v, np.ndarray)} for b in jbatches)
    assert first["audio_waveforms"].shape[1] == 2
    assert (first["audio_valid_frames"] == -1).any()  # the id without a WAV

    jm = JaxVALOR(tiny_model_config(**TINY))
    jspec = parse_task(RET)
    params = jax.jit(lambda r, b: jm.init(r, b, jspec, True, True))(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in first.items()})["params"]
    # the modules that ret%tva%tv does not reach (the fusion encoder, the CLIP
    # text tower beside BERT text) keep the port's seeded weights
    tcfg_model = torch_config(tiny_model_config(**TINY))
    sd = init_params(tcfg_model, seed=0, device="cpu")
    sd.update(params_from_jax(_np(params)))
    tm = load_model(tcfg_model, sd, "cpu")
    loss = jax.jit(lambda p, b: jm.apply({"params": p}, b, jspec, True, False))
    for batch in (first, second):
        want = loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            got = tm({k: torch.from_numpy(v) for k, v in batch.items()}, spec, True, False)
        assert got.keys() == want.keys() == {"contra_loss"}
        np.testing.assert_allclose(float(got["contra_loss"]), float(want["contra_loss"]), rtol=TOL, atol=TOL)

    jrep = jvalidate(jm, params, make_eval_step(jm), iter(jbatches), jspec, "fine")
    trep = validate_ret(tm, eval_step, iter(tbatches), spec, "fine")
    assert trep.keys() == jrep.keys()
    for k in jrep:
        np.testing.assert_allclose(trep[k], jrep[k], rtol=1e-6, err_msg=k)


# -- cli.train -----------------------------------------------------------------
def test_main_trains_two_flows_and_saves(config, tmp_path, dataset):
    path = config(train=[_flow(dataset, "train", "pt_contra%tv_caption%tv", 4, epoch=1),
                         _flow(dataset, "train", RET, 4, epoch=2)], num_train_steps=4)
    trainer = _main("--config", path, "--first_eval", "true")
    out = tmp_path / "out"
    assert json.loads((out / "hps.json").read_text())["train"]["num_train_steps"] == 4
    assert os.listdir(out / "ckpt") == ["step_4"]
    log = (out / "log" / "train.log").read_text()
    assert "first-eval fix" in log and "eval fix @ 4" in log
    assert trainer.state.step == 4 and trainer.state.optimizer.gradient_step == 4
    tasks = {h[1].split("--")[0] for h in trainer.history}
    assert tasks <= {"pt_contra%tv_caption%tv", RET} and len(trainer.history) == 4
    for _, task, metrics in trainer.history:
        assert all(np.isfinite(v) for v in metrics.values())
        assert ("caption_loss" in metrics) == task.startswith("pt_")


def test_main_resumes_from_the_latest_checkpoint(config, tmp_path):
    path = config()
    first = _main("--config", path)
    saved = {k: v.clone() for k, v in first.state.model.state_dict().items()}
    second = _main("--config", path, "--resume", "true", "--num_train_steps", "4")
    assert [h[0] for h in second.history] == [3, 4]
    assert second.state.optimizer.gradient_step == 4 and second.state.optimizer.count == 4
    assert sorted(os.listdir(tmp_path / "out" / "ckpt")) == ["step_2", "step_4"]
    from valor_tpu_torch.train.checkpoints import ModelSaver

    restored = ModelSaver(str(tmp_path / "out")).restore(step=2)
    assert restored["micro_step"] == 2
    for k, v in saved.items():
        assert torch.equal(restored["params"][k], v), k


def test_zero_shot_evaluates_and_stops(config, tmp_path):
    assert _main("--config", config(), "--zero_shot", "true") is None
    assert "zero-shot fix" in (tmp_path / "out" / "log" / "train.log").read_text()
    assert os.listdir(tmp_path / "out" / "ckpt") == []


def test_evaluate_reports_equal_those_of_train_zero_shot(config, tmp_path):
    """``python -m valor_tpu_torch.cli.evaluate`` is ``cli.train`` with
    ``--zero_shot true``: the same reports, nothing trained or saved, with
    ``--device`` passed through (and a ``--zero_shot`` of the caller kept)."""
    from valor_tpu_torch.cli import evaluate

    def report(out):  # the run's own report: the first in its log (later runs' logs follow)
        log = (tmp_path / out / "log" / "train.log").read_text()
        return next(x.split("zero-shot fix: ")[1] for x in log.splitlines() if "zero-shot fix" in x)

    assert _main("--config", config(output_dir=str(tmp_path / "train")), "--zero_shot", "true") is None
    assert evaluate.main(["--config", config(output_dir=str(tmp_path / "eval")), "--device", "cpu"]) is None
    assert report("eval") == report("train") and "'ravg'" in report("eval")
    assert os.listdir(tmp_path / "eval" / "ckpt") == []
    assert evaluate.main(["--config", config(output_dir=str(tmp_path / "again")), "--zero_shot", "true",
                          "--device", "cpu"]) is None
    assert report("again") == report("train")


def test_checkpoint_and_pretrain_dir_load_weights(config, tmp_path):
    first = _main("--config", config(output_dir=str(tmp_path / "run1")))
    trained = first.state.model.state_dict()
    for flag in ("--checkpoint", "--pretrain_dir"):
        path = config(output_dir=str(tmp_path / f"run{flag}"), fineweight_type="none")
        second = _main("--config", path, flag, str(tmp_path / "run1"), "--num_train_steps", "0")
        assert second.state.optimizer.gradient_step == 0
        for k, v in second.state.model.state_dict().items():
            assert torch.equal(v, trained[k]), k
        # --pretrain_dir copies the architecture keys of the run's hps.json
        assert second.cfg.model.fineweight_type == ("two" if flag == "--pretrain_dir" else "none")


def test_main_needs_a_card_unless_asked_for_the_cpu(config, monkeypatch):
    from valor_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", config()])


@pytest.mark.parametrize("case", ["checkpoint_file", "weights"])
def test_unported_paths_raise(config, dataset, tmp_path, case):
    """A ``--checkpoint`` file and public encoder weights are read now
    (tests/test_torch_convert.py); one that cannot be read raises, naming the
    file, before any training from random weights."""
    argv = []
    if case == "checkpoint_file":
        (tmp_path / "model.pt").write_bytes(b"")
        argv, name = ["--checkpoint", str(tmp_path / "model.pt")], "model.pt"
    else:
        (tmp_path / "no_weights").mkdir()
        (tmp_path / "no_weights" / "bert-base-uncased.bin").write_bytes(b"")
        name = "bert-base-uncased.bin"
    with pytest.raises(ValueError, match=name):
        _main("--config", config(), *argv)
    assert not (tmp_path / "out" / "ckpt").exists() or not os.listdir(tmp_path / "out" / "ckpt")


@pytest.mark.parametrize("case", ["pt_val", "scst", "prompts"])
def test_paths_of_the_prompt_and_scst_slice_run(config, dataset, tmp_path, case):
    """What raised before the SCST, task-prompt and pretraining-validation
    slice runs from disk: a ``pt`` evaluation flow (``validate_pt``), SCST
    finetuning of a ``cap`` flow, and a retrieval run with ``use_task_prompt``."""
    kw = {}
    if case == "pt_val":
        kw["val"] = [_flow(dataset, "val", "pt_contra%tv_caption%tv", 4)]
    elif case == "scst":
        kw.update(scst_finetuning=True, train=[_flow(dataset, "train", "cap%tva", 4)])
    else:
        kw["use_task_prompt"] = True
    trainer = _main("--config", config(**kw))
    assert [h[0] for h in trainer.history] == [1, 2]
    assert all(np.isfinite(v) for h in trainer.history for v in h[2].values())
    log = (tmp_path / "out" / "log" / "train.log").read_text()
    report = eval(next(x for x in log.splitlines() if "eval fix @ 2" in x).split("eval fix @ 2: ")[1])  # noqa: S307
    if case == "pt_val":
        assert set(report) == {"caption_acc_tv", "caption_token_acc", "contra_recall_tv"}
    else:
        assert "ravg" in report
    if case == "scst":
        assert set(trainer.history[0][2]) == {"scst_reward_tva", "caption_loss_tva"}
        assert trainer.state.step == 2 and trainer.state.optimizer.gradient_step == 2


@pytest.mark.parametrize("case", ["missing_checkpoint", "missing_pretrain_dir", "empty_checkpoint_dir",
                                  "empty_pretrain_dir", "missing_pretrain_step"])
def test_weights_that_are_not_there_raise(config, tmp_path, case):
    """A ``--checkpoint`` or ``--pretrain_dir`` that names no path, or a run
    directory without a ``ckpt/step_N``, is an error: the run must not go on
    from random weights (the JAX package trains on there without a word)."""
    flag = "--checkpoint" if "checkpoint" in case else "--pretrain_dir"
    target = tmp_path / "typo"
    argv = []
    if case.startswith("empty"):
        (target / "log").mkdir(parents=True)
    elif case == "missing_pretrain_step":
        _main("--config", config(output_dir=str(target)))  # saves ckpt/step_2 only
        argv = ["--pretrain_step", "7"]
    with pytest.raises(FileNotFoundError, match="typo"):
        _main("--config", config(), flag, str(target), *argv)
    assert not (target / "ckpt").exists() or case == "missing_pretrain_step"


def test_resume_on_a_fresh_output_dir_is_a_first_run(config, tmp_path):
    trainer = _main("--config", config(), "--resume", "true")
    assert [h[0] for h in trainer.history] == [1, 2]
    assert os.listdir(tmp_path / "out" / "ckpt") == ["step_2"]


def test_parse_cli_matches_jax():
    from valor_tpu.cli.train import parse_cli as jparse
    from valor_tpu_torch.cli.train import parse_cli

    argv = ["--learning_rate", "3e-4", "--betas", "0.8", "0.9", "--resume", "--train_batch_size", "8",
            "--new_params_name", "a", "b", "--zero_shot", "false", "--output_dir", "x"]
    assert dataclasses.asdict(parse_cli(argv)) == dataclasses.asdict(jparse(argv))


def test_tensorboard_logger_writes_scalars(tmp_path, monkeypatch):
    """The run's TB_LOGGER writes under ``<output_dir>/tb`` where a writer imports,
    and is a silent no-op where none does."""
    from valor_tpu_torch.core.logging import TensorboardLogger

    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)  # a golden file's stub, if any

    tb = TensorboardLogger()
    tb.add_scalar("before", 1.0)  # no writer yet: nothing happens
    tb.create(str(tmp_path / "tb"))
    tb.set_step(100)
    tb.log_scalar_dict({"ret/contra_loss": 1.5, "data_stall": 0.1})
    wrote = tb._writer is not None
    tb.close()
    assert tb.global_step == 100
    assert not wrote or os.listdir(tmp_path / "tb")
