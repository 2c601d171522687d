"""From a config to the port's parts: tokenizers, datasets, loaders, model and
training state (counterpart of ``valor_tpu/cli/build.py``; the reference's
train_utils.py glue: create_train_dataloaders :415-516,
create_val_dataloaders :519-576).

Each process loads its batch rank's shard (``parallel/mesh.py``: the data
rank's, or with a pipe axis folded into the batch its (data, pipe) place's;
one process is shard 0 of 1; the model ranks of one data rank load the same),
and the model
is placed on the mesh that ``cli/train.py`` made (``parallel/partition.py``).  The
tokenizer files come from ``$VALOR_BERT_VOCAB`` and ``$VALOR_CLIP_BPE`` (read
when the tokenizers are built), public encoder weights from
``$VALOR_PRETRAINED_DIR`` (converted by ``models/convert.py``).  QA flows read
``data/vqa.py``'s mapper, dataset and collates.  With ``use_task_prompt`` every
flow's collate adds the task prompts (``data/prompts.py:prompted_collate``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from valor_tpu_torch.core.config import Config, DataFlowConfig, ModelConfig
from valor_tpu_torch.core.logging import LOGGER
from valor_tpu_torch.core.tasks import parse_task
from valor_tpu_torch.data.loader import DataLoader, MetaLoader, ShardedBatchSampler
from valor_tpu_torch.data.pipeline import AudioMapper, TxtMapper, VALORDataset, VideoMapper, valor_collate
from valor_tpu_torch.data.prompts import maybe_prompt_table, prompted_collate
from valor_tpu_torch.data.vqa import QATxtMapper, VALORQADataset, valorqa_collate_test, valorqa_collate_train
from valor_tpu_torch.parallel.mesh import batch_rank, batch_world, local_batch_size


def bert_vocab_path() -> str:
    return os.environ.get("VALOR_BERT_VOCAB", "pretrained_weights/bert-base-uncased-vocab.txt")


def clip_bpe_path() -> str:
    return os.environ.get("VALOR_CLIP_BPE", "pretrained_weights/bpe_simple_vocab_16e6.txt.gz")


def build_tokenizers(cfg: ModelConfig):
    """(bert_tokenizer | None, clip_tokenizer | None) per encoder types."""
    bert_tok = clip_tok = None
    needs_bert = cfg.txt_encoder_type.startswith("bert") or cfg.multimodal_encoder_type.startswith("bert")
    needs_clip = cfg.txt_encoder_type.startswith("clip") or cfg.multimodal_encoder_type.startswith("clip")
    if needs_bert:
        from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer

        bert_tok = BertTokenizer(bert_vocab_path())
    if needs_clip:
        from valor_tpu_torch.data.tokenizers.clip_bpe import ClipBPETokenizer

        clip_tok = ClipBPETokenizer(clip_bpe_path())
    return bert_tok, clip_tok


def build_dataset(flow: DataFlowConfig, mcfg: ModelConfig, tokenizers, training: bool) -> VALORDataset:
    bert_tok, clip_tok = tokenizers
    ds = flow.datasets[0]
    spec = parse_task(flow.task)
    if spec.family == "qa":
        txt_mapper = QATxtMapper(ds.txt, flow.max_txt_len, bert_tok, clip_tok, training)
    else:
        txt_mapper = TxtMapper(ds.txt, flow.max_txt_len, bert_tok, clip_tok, training) if ds.txt else None
    video_mapper = (
        VideoMapper(
            ds.video,
            resolution=mcfg.video_resolution,
            sample_num=flow.video_sample_num if ds.datatype.startswith("video") else 1,
            datatype=ds.datatype,
            transforms=ds.video_transforms,
            encoder_type=mcfg.video_encoder_type,
            training=training,
            output_uint8=mcfg.uint8_pixels,
        )
        if ds.video and spec.uses_video
        else None
    )
    audio_mapper = (
        AudioMapper(
            ds.audio,
            sample_num=flow.audio_sample_num,
            melbins=mcfg.audio_melbins,
            target_length=mcfg.audio_target_length,
            frame_shift_ms=mcfg.audio_frame_shift,
            mean=mcfg.audio_mean,
            std=mcfg.audio_std,
            training=training,
            device_fbank=mcfg.device_fbank,
        )
        if ds.audio and spec.uses_audio
        else None
    )
    dataset_cls = VALORQADataset if spec.family == "qa" else VALORDataset
    return dataset_cls(ds.ids_path, txt_mapper, video_mapper, audio_mapper, training)


def collate_for(task: str, training: bool):
    """The collate function of a flow: QA flows tile their answers."""
    if parse_task(task).family == "qa":
        return valorqa_collate_train if training else valorqa_collate_test
    return valor_collate


def build_train_loaders(cfg: Config, tokenizers, seed: int = 0, pin_memory: bool = False) -> MetaLoader:
    """The train flows' loaders behind one ``MetaLoader`` (the JAX package's
    seeds and mixing order).  Across processes each rank loads its shard of
    every global batch (``batch_size`` over the batch axis's ranks).  ``pin_memory`` pins
    each batch in the loader's background thread, for a CUDA prefetcher."""
    loaders: Dict[str, Tuple[Any, int]] = {}
    prompts = maybe_prompt_table(cfg.model, tokenizers)
    world = batch_world()
    for i, flow in enumerate(cfg.data_train):
        dataset = build_dataset(flow, cfg.model, tokenizers, training=True)
        sampler = ShardedBatchSampler(len(dataset), batch_size=local_batch_size(max(flow.batch_size, 1), world),
                                      shard=batch_rank(), n_shards=world, shuffle=True, seed=seed)
        collate = prompted_collate(collate_for(flow.task, True), prompts, parse_task(flow.task))
        loader = DataLoader(dataset, sampler, collate, n_workers=max(flow.n_workers, 1),
                            pin_memory=pin_memory)
        name = f"{flow.task}--{flow.datasets[0].name or i}"
        loaders[name] = (loader, max(flow.epoch, 1))
        LOGGER.info(f"train flow {name}: {len(dataset)} items, batch {flow.batch_size}, ratio {flow.epoch}")
    return MetaLoader(loaders, accum_steps=cfg.train.gradient_accumulation_steps,
                      seed=cfg.train.seed, mix_type=cfg.train.dataset_mix_type)


def build_val_loaders(cfg: Config, tokenizers) -> List[Tuple[str, DataLoader, Any]]:
    """[(name, loader, task spec)] of the evaluation flows, in order.  Across
    processes the batch axis's shards cover every item once (the last ragged,
    a rank's maybe empty), each rank's batch ``batch_size`` over those ranks
    rounded up: batch k of all ranks is one process's batch k (the JAX
    package's hosts each take the whole ``batch_size``)."""
    out = []
    prompts = maybe_prompt_table(cfg.model, tokenizers)
    world = batch_world()
    for i, flow in enumerate(cfg.data_val):
        dataset = build_dataset(flow, cfg.model, tokenizers, training=False)
        sampler = ShardedBatchSampler(len(dataset), batch_size=-(-flow.batch_size // world), shard=batch_rank(),
                                      n_shards=world, shuffle=False)
        collate = prompted_collate(collate_for(flow.task, False), prompts, parse_task(flow.task))
        loader = DataLoader(dataset, sampler, collate, n_workers=max(flow.n_workers, 1))
        name = flow.name or (flow.datasets[0].name if flow.datasets else str(i))
        out.append((name, loader, parse_task(flow.task)))
    return out


# public-checkpoint filenames the reference hardcodes
# (model/modeling.py:514,560-598,621)
_CLIP_WEIGHTS = {
    "clip_vit_base_16": "clip-vit-base-16.pt",
    "clip_vit_base_32": "clip-vit-base-32.pt",
    "clip_vit_large_14": "clip-vit-large-14.pt",
    "clip_vit_large_14_336": "clip-vit-large-14-336px.pt",
}
_SWIN_WEIGHTS = {
    "videoswin": "ckpt_video-swin.pt",
    "videoswin_base_k400_1k": "videoswin_base_k400_1k.pth",
    "videoswin_base_k400_22k": "videoswin_base_k400_22k.pth",
    "videoswin_base_k600_22k": "videoswin_base_k600_22k.pth",
}
_AST_WEIGHTS = "audioset_10_10_0.4593.pth"
_BERT_WEIGHTS = "bert-base-uncased.bin"


def converted_state_dict(tree) -> Dict[str, Any]:
    """A converted flax-layout tree (``models/convert.py``: CLIP, VideoSwin's
    ``video_encoder``, AST, BERT) as ``state_dict`` entries
    (``models/bridge.py:params_from_jax``)."""
    from valor_tpu_torch.models.bridge import params_from_jax

    return params_from_jax(tree)


def public_weight_files(mcfg: ModelConfig) -> List[Tuple[str, str]]:
    """(kind, path) of each public encoder checkpoint that ``mcfg`` asks for
    and ``$VALOR_PRETRAINED_DIR`` (default ``pretrained_weights/``) holds, in
    the JAX package's order: ``initial_vision`` gates CLIP/VideoSwin (+AST),
    ``initial_multimodal`` BERT (+cls head)."""
    pdir = os.environ.get("VALOR_PRETRAINED_DIR", "pretrained_weights")
    wanted = []  # (kind, file name)
    if mcfg.initial_vision:
        if mcfg.video_encoder_type.startswith("clip") or mcfg.txt_encoder_type.startswith("clip"):
            name = (mcfg.video_encoder_type if mcfg.video_encoder_type.startswith("clip")
                    else mcfg.txt_encoder_type)
            wanted.append(("clip", _CLIP_WEIGHTS.get(name, "")))
        if mcfg.video_encoder_type.startswith("videoswin"):
            wanted.append(("videoswin", _SWIN_WEIGHTS.get(mcfg.video_encoder_type, "")))
        wanted.append(("ast", _AST_WEIGHTS))
    if mcfg.initial_multimodal:
        wanted.append(("bert", _BERT_WEIGHTS))
    return [(kind, os.path.join(pdir, f)) for kind, f in wanted if f and os.path.exists(os.path.join(pdir, f))]


def convert_public(kind: str, path: str, mcfg: ModelConfig):
    """The flax-layout tree of one public encoder checkpoint
    (``models/convert.py``) at ``mcfg``'s resolution and spectrogram grid."""
    from valor_tpu_torch.models import convert as C

    if kind == "clip":
        return C.convert_clip(path, resolution=mcfg.video_resolution)
    if kind == "ast":
        return C.convert_ast(path, melbins=mcfg.audio_melbins, target_length=mcfg.audio_target_length,
                             patch=mcfg.audio_patch_size)
    return {"videoswin": C.convert_videoswin, "bert": C.convert_bert}[kind](path)


def initialize_encoder_weights(mcfg: ModelConfig, state_dict):
    """Load public encoder checkpoints at model construction (the JAX
    package's lookup; reference model/modeling.py:560-660): each file of
    ``public_weight_files`` converted and shape-adapted onto ``state_dict`` in
    that order.  Missing files are skipped with a log line, so random-init
    runs (tests, ablations) proceed."""
    from valor_tpu_torch.train.checkpoints import adapt_pretrained_params

    pdir = os.environ.get("VALOR_PRETRAINED_DIR", "pretrained_weights")
    found = public_weight_files(mcfg)
    for kind, path in found:
        LOGGER.info(f"initialising {kind} from {pdir}")
        state_dict = adapt_pretrained_params(converted_state_dict(convert_public(kind, path, mcfg)), state_dict)
    if not found:
        LOGGER.info(f"no public encoder weights under {pdir!r}; encoders random-init")
    return state_dict


def model_weights(model_cfg: ModelConfig, checkpoint: Optional[str] = None, device=None):
    """Weights for ``VALORModel(model_cfg)`` on ``device``: random from seed 0
    by the JAX package's initializers (``models/bridge.py:init_params``), then,
    with ``checkpoint`` (one of the port's run directories), the parameters of
    its latest ``ckpt/step_N`` shape-adapted over them
    (``cli/train.py:restore_weights``, which raises ``FileNotFoundError``
    where the path or the checkpoint is missing)."""
    from valor_tpu_torch.cli.train import restore_weights
    from valor_tpu_torch.models.bridge import init_params
    from valor_tpu_torch.train.checkpoints import adapt_pretrained_params

    sd = init_params(model_cfg, 0, device, law="jax")
    if checkpoint:
        sd = adapt_pretrained_params(restore_weights(checkpoint)["params"], sd)
    return sd


def install_mesh_switches(mcfg: ModelConfig) -> None:
    """Expert parallelism where the config has MoE experts, sequence
    parallelism where it asks for it, and the fusion pipeline with
    ``fusion_pipeline_microbatches`` where it has stages
    (``valor_tpu/cli/build.py:280-294``); the first two split over the model
    axis and do nothing on a model axis of one rank, the pipeline runs over
    the pipe axis and does nothing without one.  Their counts start again at
    0."""
    from valor_tpu_torch.ops.moe import set_expert_sharding
    from valor_tpu_torch.parallel.activations import set_sequence_sharding
    from valor_tpu_torch.parallel.pipeline import set_pipeline

    set_sequence_sharding(mcfg.sequence_parallel)
    set_expert_sharding(mcfg.fusion_moe_experts > 0)
    set_pipeline(max(mcfg.fusion_pipeline_stages, 0), mcfg.fusion_pipeline_microbatches)


def build_model_and_state(cfg: Config, device, load_weights=None):
    """A training ``TrainState`` on ``device``: seeded weights
    (``models/bridge.py:init_params`` from ``cfg.train.seed``, by the JAX
    package's initializers, drawn whole whatever the mesh), the encoder weight
    lookup, then ``load_weights(model)`` (the caller's whole weights, where
    given), the placement on this process's mesh (``parallel/partition.py:
    shard_model``: tensor parallelism with ``model_shards``, ``fsdp``; each
    rank keeps its blocks) with the expert and sequence parallelism switches
    of the config (``install_mesh_switches``), and ``GroupedAdam`` over the
    model's parameters."""
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.parallel.partition import shard_model
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState

    sd = initialize_encoder_weights(cfg.model, init_params(cfg.model, seed=cfg.train.seed, device=device, law="jax"))
    model = train_model(cfg.model, sd, device)
    del sd
    n_params = sum(p.numel() for p in model.parameters())
    LOGGER.info(f"model has {n_params / 1e6:.1f}M params")
    if load_weights is not None:
        load_weights(model)
    pl = shard_model(model, fsdp=cfg.train.fsdp)
    install_mesh_switches(cfg.model)
    split = [n for n, p in pl.placements.items() if p.split]
    if split:
        LOGGER.info(f"placed on data={pl.n_data} x model={pl.n_model}: {len(split)} leaves split "
                    f"({len(pl.tp)} tensor-parallel modules), {len(pl.f11)} kept whole (F11); this rank holds "
                    f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")
    optimizer = build_optimizer(model, cfg.train, frozen_vision=cfg.model.frozen_vision,
                                frozen_multimodal=cfg.model.frozen_multimodal)
    return TrainState(model, optimizer)
