"""The port across processes from disk: evaluation reports, ``cli.train`` and
its refusals, two gloo ranks on the CPU against one process.

The fixture is ``data/synthetic.py``'s retrieval, caption and QA datasets at a
tiny size, over 7 evaluation ids (an odd count: the ranks hold 4 and 3 items,
the last batch ragged) and over 1 id (one rank's shard empty); the model is
the tiny config with BERT text (as ``tests/test_torch_cli.py``'s).  Through
``cli/train.py:make_validate_fn``, the ``ret``, ``pt`` (unimlm masks drawn),
``cap`` and ``qa`` reports of two ranks equal one process's (1e-6, fp32
features extracted in other batch sizes), on both ranks.  ``cli.train``
under two ranks gives one process's losses within 1e-4 (the whole-model
tolerance) on a training flow that draws nothing at random on the host.
"""

import json
import os
import sys

import numpy as np
import pytest

from valor_tpu_torch.parallel.launch import run_local

WORLD = 2
LIMIT = 180
TINY = dict(
    video_encoder_type="clip_vit_tiny", txt_encoder_type="bert_base_uncased", init_clip_head=False,
    video_resolution=32, audio_melbins=16, audio_target_length=32, audio_patch_size=16,
    fusion_hidden=32, fusion_layers=2, fusion_heads=2, fusion_intermediate=64, fusion_vocab=512,
    audio_hidden=32, audio_layers=2, audio_heads=2, audio_intermediate=64, contra_dim=16,
    dtype="float32", dropout=0.0, max_generation_len=4, seed=3,
)
FLOWS = {"ret": ("ret", "ret%tva%tv"), "pt": ("ret", "pt_contra%tva%tv_caption%tva%tv"),
         "cap": ("cap", "cap%tva"), "qa": ("qa", "qa%tva")}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from valor_tpu_torch.data.synthetic import write_caption_dataset, write_qa_dataset, write_retrieval_dataset

    root = tmp_path_factory.mktemp("ddp")
    ret = write_retrieval_dataset(str(root / "ret"), n_train=8, n_val=7, n_frames=2, frame_size=(64, 48),
                                  wav_seconds=1.0, captions_per_train_id=1, workers=2)
    out = {"ret": ret, "cap": write_caption_dataset(str(root / "cap"), 8, 7, captions_per_id=2, media=ret),
           "qa": write_qa_dataset(str(root / "qa"), 8, 7, media=ret)}
    for name, paths in out.items():  # the first evaluation id alone
        with open(paths["val_ids"]) as f:
            first = json.load(f)[:1]
        paths["one_id"] = str(root / f"{name}_one_id.json")
        with open(paths["one_id"], "w") as f:
            json.dump(first, f)
    return out


def _flow(p, split, task, batch, ids=None, **kw):
    ds = {"name": "fix", "ids_path": ids or p[f"{split}_ids"], "txt": p[f"{split}_txt"], "video": p["frames"],
          "audio": p["audio"], "datatype": "video", "video_transforms": "none"}
    flow = {"task": task, "batch_size": batch, "video_sample_num": 2, "audio_sample_num": 1,
            "max_txt_len": 6, "n_workers": 1, **kw}
    return {"datasets": [ds], **flow} if split == "train" else {**ds, **flow, "name": kw.get("name", "fix")}


def _config(data, path, out_dir, val, train=None, **extra):
    cfg = {**TINY, "learning_rate": 1e-3, "num_train_steps": 2, "valid_steps": 0, "first_eval": False,
           "output_dir": out_dir, **extra,
           "data_cfg": {"train": train or [_flow(data["ret"], "train", "ret%tv", 4)], "val": val}}
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def _env(data) -> dict:
    return {"VALOR_BERT_VOCAB": data["ret"]["vocab"],
            "VALOR_PRETRAINED_DIR": os.path.join(os.path.dirname(data["ret"]["vocab"]), "no_weights")}


@pytest.fixture
def environ(data, monkeypatch):
    """The fixture's tokenizer and weight paths for the one-process runs in
    this test's process (a rank sets them in its own process)."""
    for k, v in _env(data).items():
        monkeypatch.setenv(k, v)
    # the golden-file tests stub tensorboardX (SummaryWriter=object) for the rest of their process
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)


def _reports(data, config_path, group):
    """Every evaluation flow's report through ``make_validate_fn``."""
    from valor_tpu_torch.cli.build import build_tokenizers
    from valor_tpu_torch.cli.train import make_validate_fn
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import init_params, load_model
    from valor_tpu_torch.parallel import mesh as P

    if group:  # a rank, in a process of its own
        os.environ.update(_env(data))
        P.init_data_parallel("gloo", "cpu")
    cfg = load_config(config_path)
    model = load_model(cfg.model, init_params(cfg.model, 0, "cpu"), "cpu")
    return make_validate_fn(cfg, build_tokenizers(cfg.model))(model, 0)


def _val_flows(data, one_id):
    return [_flow(data[src], "val", task, 4, ids=data[src]["one_id"] if one_id else None, name=name)
            for name, (src, task) in FLOWS.items()]


@pytest.mark.parametrize("one_id", [False, True], ids=["odd_count", "empty_shard"])
def test_every_report_of_two_ranks_equals_one_process(data, tmp_path, environ, one_id):
    cfg_path = _config(data, tmp_path / "config.json", str(tmp_path / "out"), _val_flows(data, one_id))
    one = _reports(data, cfg_path, group=False)
    ranks = run_local(_reports, WORLD, data, cfg_path, True, timeout=LIMIT)
    assert set(one) == set(FLOWS)
    assert set(one["pt"]) >= {"caption_token_acc", "contra_recall_tva"} and "CIDEr" in one["cap"]
    for rep in ranks:
        assert rep.keys() == one.keys()
        for name in one:
            assert rep[name].keys() == one[name].keys(), name
            for k, v in one[name].items():
                np.testing.assert_allclose(rep[name][k], v, rtol=1e-6, atol=1e-9, err_msg=f"{name} {k}")
    with open(data["qa"]["one_id" if one_id else "val_txt"]) as f:
        qa_ids = json.load(f)
    n_pairs = len(qa_ids) if one_id else sum(len(v) for v in qa_ids.values())
    if not one_id:  # rank 0 wrote the merged dumps
        with open(tmp_path / "out" / "results_test_qa" / "step0_gt.json") as f:
            assert len(json.load(f)) == n_pairs


def _train(data, argv, rank=True):
    """``cli.train``'s losses by micro-step; ``rank``: in a rank's own process."""
    from valor_tpu_torch.cli.train import main

    if rank:
        os.environ.update(_env(data))
    trainer = main(argv + ["--device", "cpu"])
    return [(m, t, v) for m, t, v in trainer.history]


def test_cli_train_under_two_ranks_gives_one_process_losses(data, tmp_path, environ):
    """Two steps of ``ret%tv`` (one caption an id, one frame a chunk: the
    host draws nothing) from two ranks, against one process; rank 0 alone
    writes the run's files."""
    runs = {}
    for name, ranks in (("one", 0), ("two", WORLD)):
        out = tmp_path / name
        argv = ["--config", _config(data, tmp_path / f"{name}.json", str(out), [])]
        runs[name] = ([_train(data, argv, rank=False)] if not ranks
                      else run_local(_train, ranks, data, argv + ["--dist_backend", "gloo"], timeout=LIMIT))
        assert (out / "hps.json").exists() and (out / "ckpt" / "step_2" / "state.pt").exists()
        assert (out / "log" / "train.log").read_text().count("model has") == 1
    one = runs["one"][0]
    assert [h[0] for h in one] == [1, 2]
    for history in runs["two"]:
        assert [h[0] for h in history] == [1, 2]
        for (_, _, got), (_, _, want) in zip(history, one):
            assert got.keys() == want.keys()
            for k in ("contra_loss", "total_loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def _refused(data, argv):
    try:
        _train(data, argv)
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "ran"


@pytest.mark.parametrize("extra,error", [
    (["--fusion_pipeline_stages", "3"],
     "ValueError: fusion_pipeline_stages 3 x model_shards 1 does not divide the 2 ranks"),
    (["--fusion_pipeline_stages", "2", "--fusion_moe_experts", "4"],
     "ValueError: pipeline_stages and moe_experts are mutually exclusive"),
    (["--model_shards", "3"], "ValueError: model_shards 3 does not divide the 2 ranks"),
    (["--dist_backend", "nccl"], "ValueError: --dist_backend nccl needs a CUDA device"),
])
def test_two_ranks_refuse(data, tmp_path, extra, error):
    """Pipeline stages or a model axis that do not divide the ranks raise
    across ranks, as do MoE layers with stages (the JAX package's refusal)
    and NCCL on the CPU: nothing is silently ignored, and no backend
    switched."""
    cfg_path = _config(data, tmp_path / "config.json", str(tmp_path / "out"), [])
    for got in run_local(_refused, WORLD, data, ["--config", cfg_path] + extra, timeout=LIMIT):
        assert got.startswith(error), got
