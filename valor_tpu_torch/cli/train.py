"""Training entry point of the port (counterpart of ``valor_tpu/cli/train.py``).

    python -m valor_tpu_torch.cli.train --config configs/retrieval-msrvtt.json \
        --output_dir out/ret-msrvtt [--flag value ...] [--device cpu]

Any flat config key can be overridden on the command line (CLI wins over
JSON, JSON over defaults — reference: utils/misc.py:26-36).  The run takes
the CUDA card unless ``--device`` names another device; with no card and no
``--device`` it raises.  It writes ``hps.json``, ``log/train.log``, TensorBoard
scalars under ``tb/`` (when a writer imports) and checkpoints under ``ckpt/``
into ``output_dir``.  ``--resume true`` restarts from the latest checkpoint
there, at its micro-step; ``--checkpoint <dir>`` (one of the port's own run
directories) and ``--pretrain_dir <dir>`` (with ``--pretrain_step``) load
weights, shape-adapted, and raise ``FileNotFoundError`` where the path does
not exist or holds no ``ckpt/step_N`` (the JAX package trains from random
weights there); ``--checkpoint <file>`` converts a torch artifact (a released
VALOR ``.pt``, a CLIP JIT archive, a BERT ``.bin``, an AST checkpoint) by key
inspection (``models/convert.py:load_converted``) and loads it shape-adapted;
``--zero_shot true`` evaluates and stops; ``--first_eval`` evaluates before
training.  Evaluation flows run ``validate_ret``,
``validate_cap`` (caption metrics over the whole set, with step dumps and
``submit_format`` files under ``<output_dir>/results_test_<name>``),
``validate_qa`` (accuracy, with the ground-truth and prediction dumps there) or
``validate_pt`` (masked-token accuracies and a recall per contrastive group).
``--scst_finetuning true`` finetunes captions by SCST, its reward fitted on the
first train flow's annotations; it takes its weights from a caption run with
``--pretrain_dir <caption run>``.  ``use_task_prompt`` adds the task prompts
to every batch (``data/prompts.py``).

Data parallelism across processes, one a card (the JAX package's ``data``
mesh axis and ``jax.distributed``):

    python -m torch.distributed.run --nproc_per_node 8 -m valor_tpu_torch.cli.train \
        --config configs/pretrain-valor-base.json [--dist_backend nccl|gloo]

Under the launcher's environment ``main`` joins the process group
(``parallel/mesh.py:init_data_parallel``; ``--dist_backend`` defaults to nccl on
a card and gloo with ``--device cpu``; gloo also shares one card between ranks,
which NCCL refuses), each rank takes ``cuda:$LOCAL_RANK``, its shard of every
global batch (``batch_size`` is global) and of every evaluation set, and the
step's losses, gradients and updates are those of one process on the global
batch; rank 0 writes ``hps.json``, the log, ``tb/`` and the checkpoints.  SCST
runs across processes (each rank decodes its rows, every rank rewards the
global batch), and so does ``--zero_optimizer true`` (ZeRO-1: the optimizer
state split over the data ranks, ``train/optimizer.py``).  The parameter axes:
``--model_shards M`` makes a (W / M data) x (M model) grid with tensor
parallelism over the model axis (``parallel/mesh.py:make_mesh``), ``--fsdp
true`` splits the large parameters over the data axis
(``parallel/partition.py``, ``parallel/fsdp.py``); the M ranks of one data
rank load the same batches.  On the model axis MoE experts split too
(``fusion_moe_experts`` divisible by M, ``ops/moe.py``), and ``--sequence_parallel
true`` splits the fusion sequence between layers (``parallel/activations.py``).
``--fusion_pipeline_stages S`` adds a pipe axis of S ranks (rank r's
pipe rank is r % S): the fusion stack runs S stages over it
(``parallel/pipeline.py``; ``--fusion_pipeline_interleave V`` the
interleaved schedule, ``--fusion_pipeline_microbatches M``), and outside the
stack the pipe ranks split each global batch that divides by data x pipe, as
extra data parallelism (else the pipe ranks of one data rank load the same
batches); a grid that does not divide the ranks is refused
(``parallel/mesh.py:check_data_parallel``).  Without the launcher's environment
it runs one process, as before; where the caller has joined the group already
(several runs in one launch), ``main`` runs in it and leaves it up.
``--async_checkpoint true`` writes checkpoints in the background
(``train/checkpoints.py``).  Untrained weights are drawn by the JAX package's
initializers (``models/bridge.py:init_params(law="jax")``).  ``prng_impl`` and ``VALOR_DEBUG_NANS`` have no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys
from typing import Any, Dict, Optional

from valor_tpu_torch.core.config import Config, config_to_json, load_config
from valor_tpu_torch.core.device import resolve_device
from valor_tpu_torch.core.logging import LOGGER, TB_LOGGER, add_log_to_file, is_main_process
from valor_tpu_torch.parallel.mesh import (
    batch_rank, check_data_parallel, init_data_parallel, is_initialized, launched, make_mesh, shutdown, world_size,
)


def parse_cli(argv=None) -> Config:
    parser = argparse.ArgumentParser(description="VALOR trainer (PyTorch)")
    parser.add_argument("--config", type=str, default=None)
    args, unknown = parser.parse_known_args(argv)
    overrides: Dict[str, Any] = {}
    key = None
    for tok in unknown:
        if tok.startswith("--"):
            key = tok[2:]
            overrides[key] = True  # bare flag
        elif key is not None:
            prev = overrides[key]
            if prev is True:
                overrides[key] = _parse_value(tok)
            elif isinstance(prev, list):
                prev.append(_parse_value(tok))
            else:
                overrides[key] = [prev, _parse_value(tok)]
    return load_config(args.config, overrides)


def _parse_value(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def make_validate_fn(cfg: Config, tokenizers):
    """``run(model, step) -> {name: report}`` over the evaluation flows:
    ``ret`` through ``validate_ret``, ``cap`` through ``validate_cap``, ``qa``
    through ``validate_qa`` and ``pt`` through ``validate_pt``, as the JAX
    package's."""
    from valor_tpu_torch.cli.build import build_val_loaders
    from valor_tpu_torch.eval import validate as V
    from valor_tpu_torch.train.step import eval_step

    val_loaders = build_val_loaders(cfg, tokenizers)
    bert_tok = tokenizers[0]
    m, out_dir = cfg.model, cfg.train.output_dir or "output"

    def run(model, step: int):
        reports = {}
        for (name, loader, task), flow in zip(val_loaders, cfg.data_val):
            result_dir = os.path.join(out_dir, f"results_test_{name}")
            if task.family == "ret":
                reports[name] = V.validate_ret(model, eval_step, iter(loader), task, m.contra_type,
                                               m.dual_softmax, m.evaluate_ret_text)
            elif task.family == "cap":
                # submission mode has no annotation file (reference train_utils.py:448)
                ann = {}
                if not cfg.train.submit_format and flow.datasets[0].txt:
                    with open(flow.datasets[0].txt) as f:
                        ann = {str(k): v if isinstance(v, list) else [v] for k, v in json.load(f).items()}
                reports[name] = V.validate_cap(
                    model, iter(loader), task, bert_tok, ann, caption_type=m.caption_type,
                    max_len=m.max_generation_len, beam_size=m.beam_size, result_dir=result_dir,
                    step=step, submit_format=cfg.train.submit_format or None)
            elif task.family == "qa":
                with open(flow.datasets[0].txt) as f:
                    answers = json.load(f)
                reports[name] = V.validate_qa(
                    model, iter(loader), task, bert_tok, answers, caption_type=m.caption_type,
                    max_len=m.max_generation_len, beam_size=m.beam_size_qa, result_dir=result_dir,
                    step=step, dset_name=name)
            else:
                reports[name] = V.validate_pt(model, eval_step, loader, task, m.contra_type)
        return reports

    return run


def restore_weights(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The payload of checkpoint ``step`` (the latest when None) of the run
    directory ``path``; ``FileNotFoundError`` where the path does not exist or
    holds no ``ckpt/step_N``, rather than train from random weights."""
    from valor_tpu_torch.train.checkpoints import ModelSaver

    if not os.path.isdir(path):
        raise FileNotFoundError(f"no such run directory: {path!r}")
    restored = None
    if os.path.isdir(os.path.join(path, "ckpt")):  # ModelSaver would make it
        restored = ModelSaver(path, remove_before_ckpt=False).restore(step=step)
    if restored is None:
        raise FileNotFoundError(f"no ckpt/step_N checkpoint found in {path!r}")
    return restored


def _adapted(model, params) -> Dict[str, Any]:
    from valor_tpu_torch.train.checkpoints import adapt_pretrained_params

    return adapt_pretrained_params(params, model.state_dict())


def main(argv=None):
    """Train (or, with ``--zero_shot``, evaluate) as the config says.  Returns
    the ``Trainer`` after its run (None after a zero-shot evaluation)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None)
    pre.add_argument("--dist_backend", default=None, choices=("nccl", "gloo"))
    dev_args, argv = pre.parse_known_args(argv)
    if not launched():
        return _run(argv, resolve_device(dev_args.device))
    joined = is_initialized()  # the caller's group (several runs in one launch) is left up
    dp = init_data_parallel(dev_args.dist_backend, dev_args.device)
    try:
        if dp.rank:
            LOGGER.setLevel(logging.WARNING)  # rank 0 logs the run
        return _run(argv, dp.device)
    finally:
        if not joined:
            shutdown()


def _run(argv, device):
    cfg = parse_cli(argv)
    check_data_parallel(cfg, world_size())
    if cfg.train.pretrain_dir:
        from valor_tpu_torch.core.config import inherit_pretrain_config

        inherited = inherit_pretrain_config(cfg)
        if inherited:
            LOGGER.info(f"inherited from pretrain hps.json: {inherited}")
    many = world_size() > 1
    stages = max(cfg.model.fusion_pipeline_stages, 1) if many else 1
    model_shards = cfg.train.model_shards if many else 1
    folds = all(max(f.batch_size, 1) % (world_size() // model_shards) == 0 for f in cfg.data_train)
    grid = make_mesh(model_shards, device, stages, fold_pipe=folds)
    random.seed(cfg.train.seed + batch_rank())
    out_dir = cfg.train.output_dir or "output"
    if is_main_process():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "hps.json"), "w") as f:
            f.write(config_to_json(cfg))
        add_log_to_file(os.path.join(out_dir, "log", "train.log"))
        TB_LOGGER.create(os.path.join(out_dir, "tb"))
    if world_size() > 1:
        LOGGER.info(f"mesh data={grid.data_world} x model={grid.model_world}"
                    + (f" x pipe={grid.pipe_world} (batch over {grid.batch_world} ranks)"
                       if grid.pipe_world > 1 else ""))

    from valor_tpu_torch.cli.build import build_model_and_state, build_tokenizers, build_train_loaders
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state
    from valor_tpu_torch.train.trainer import Trainer

    tokenizers = build_tokenizers(cfg.model)
    validate_fn = make_validate_fn(cfg, tokenizers) if cfg.data_val else None
    meta = (build_train_loaders(cfg, tokenizers, seed=cfg.train.seed, pin_memory=device.type == "cuda")
            if not cfg.train.zero_shot else None)

    saver = ModelSaver(out_dir, cfg.train.remove_before_ckpt, use_async=cfg.train.async_checkpoint)
    restored = saver.restore() if cfg.train.resume else None

    def load_weights(model):
        """Weights loaded whole, before the model is placed on the mesh."""
        if cfg.train.resume:
            return
        if cfg.train.pretrain_dir:
            # --pretrain_step selects a checkpoint other than the latest
            # (reference train_utils.py:120-121)
            params = restore_weights(cfg.train.pretrain_dir, cfg.train.pretrain_step)["params"]
        elif cfg.train.checkpoint and os.path.isfile(cfg.train.checkpoint):
            # a torch artifact: full VALOR .pt / CLIP jit archive / bert bin / ast,
            # converted by key inspection
            from valor_tpu_torch.cli.build import converted_state_dict
            from valor_tpu_torch.models.convert import load_converted

            params = converted_state_dict(load_converted(cfg.train.checkpoint,
                                                         resolution=cfg.model.video_resolution))
        elif cfg.train.checkpoint:
            params = restore_weights(cfg.train.checkpoint)["params"]
        else:
            return
        model.load_state_dict(_adapted(model, params))
        del params  # a full-width payload holds 4.5 GB on the host

    state = build_model_and_state(cfg, device, load_weights)
    if restored:
        load_state(state, restored)
    del restored

    if cfg.train.zero_shot:
        if validate_fn:
            for name, rep in validate_fn(state.model, 0).items():
                LOGGER.info(f"zero-shot {name}: {rep}")
        return None
    if cfg.train.first_eval and validate_fn:
        for name, rep in validate_fn(state.model, 0).items():
            LOGGER.info(f"first-eval {name}: {rep}")

    scorer = None
    if cfg.model.scst_finetuning:
        from valor_tpu_torch.eval.scorer import Scorer

        ds = cfg.data_train[0].datasets[0]
        with open(ds.ids_path) as f:
            scorer = Scorer(ds.txt, json.load(f), tokenizers[0])
    trainer = Trainer(cfg, state, meta, validate_fn=validate_fn, saver=saver,
                      prefetch=cfg.train.prefetch, scorer=scorer)
    trainer.run()
    for loader in meta.name2loader.values():
        loader.close()
    return trainer


if __name__ == "__main__":
    main()
