"""Configuration system.

Three-level override semantics matching the reference
(reference: utils/misc.py:26-36 `parse_with_config` — CLI beats JSON —
plus train_utils.py:59-112 convenience-flag mutation of nested data_cfg),
rebuilt as a typed dataclass tree:

  1. dataclass defaults          (the ~95 argparse defaults, train_utils.py:599-698)
  2. JSON config file            (``--config foo.json``)
  3. explicit CLI ``--key value`` overrides

All configs are plain frozen-ish dataclasses so they can be hashed into jit
static arguments where needed.

This module is the PyTorch port's own copy of ``valor_tpu/core/config.py``:
the port never imports the JAX package.  Every key is accepted so that one
JSON file configures both packages.  The knobs that only steer XLA on a TPU
are read and ignored by the port (PERF.md lists them):
``attention_logits_dtype`` (the port keeps attention logits in fp32),
``attention_layout``, ``gelu_stash_dtype``, ``remat_policy``, ``prng_impl``
and ``train_inner_steps``; the fusion pipeline knobs (``fusion_pipeline_*``)
select nothing on one card either.  ``checkpointing`` and ``remat_scope`` are
honoured (``torch.utils.checkpoint`` per encoder layer), and so are
``async_checkpoint`` (background writes, ``train/checkpoints.py``) and
``zero_optimizer`` (ZeRO-1 across processes, ``train/optimizer.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# model configuration
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    """Architecture hyper-parameters for the VALOR tri-modal model.

    Defaults mirror the reference argparse defaults
    (reference: train_utils.py:601-695) and pretrain-VALOR-base.json.
    """

    # encoders
    video_encoder_type: str = "clip_vit_base_16"
    txt_encoder_type: str = "clip_vit_base_16"
    audio_encoder_type: str = "ast"
    multimodal_encoder_type: str = "bert_base_uncased"
    share_txt_and_multimodal: bool = True
    multimodal_use_cross_attn: bool = True
    cross_attn_type: str = "va_concate"  # va_concate|va_parallel|video_audio|audio_video

    # vision
    video_resolution: int = 224
    frozen_vision: bool = False
    initial_vision: bool = True
    # NOTE: the reference parses --videoswin_timestride but never reads it
    # (train_utils.py:666 is its only occurrence); deliberately not carried.

    # audio (AST patching over log-mel)
    audio_melbins: int = 64
    audio_patch_size: int = 16
    audio_target_length: int = 512
    audio_frame_shift: int = 10
    audio_mean: float = -4.2677393
    audio_std: float = 4.5689974

    # fusion / heads
    contra_type: str = "fine"  # 'fine' | 'coarse'
    contra_dim: int = 512
    caption_type: str = "unimlm"  # 'unimlm' | 'lm'
    fineweight_type: str = "two"
    late_fusion: bool = False
    full_masker: bool = False
    use_task_prompt: bool = False
    init_clip_head: bool = True
    label_smoothing: float = 0.0
    contra_loss_ratio: float = 1.0
    dual_softmax: bool = False
    evaluate_ret_text: bool = False
    frozen_multimodal: bool = False
    initial_multimodal: bool = True

    # generation
    max_generation_len: int = 30
    beam_size: int = 3
    beam_size_qa: int = 1
    scst_finetuning: bool = False

    # text
    max_txt_len: int = 30

    # CLIP tower depth overrides (None = the preset's depth).  Smaller
    # depths support scaled-down ablations and the full-model golden
    # parity fixture (a 2-layer B/16-shaped tower is still width-768).
    clip_vision_layers: Optional[int] = None
    clip_text_layers: Optional[int] = None

    # architecture size overrides (base BERT/AST dims by default; smaller
    # values support unit tests and scaled-down ablations)
    fusion_hidden: int = 768
    fusion_layers: int = 12
    fusion_heads: int = 12
    fusion_intermediate: int = 3072
    fusion_vocab: int = 30522
    # Mixture-of-Experts fusion FFN (TPU-native extension; reference FFNs
    # are dense).  >0 swaps every fusion_moe_every-th fusion layer's FFN
    # for a top-k MoE, its experts split over the model axis where
    # model_shards divides them (ops/moe.py)
    fusion_moe_experts: int = 0
    fusion_moe_top_k: int = 2
    fusion_moe_every: int = 1
    fusion_moe_capacity_factor: float = 1.25  # expert slots = ceil(k*S*c/E)
    # grouped-query CROSS-attention in the fusion encoder: >0 projects the
    # per-layer media K/V to this many heads (must divide fusion_heads),
    # each serving a group of query heads.  Cuts cross-attn K/V activation
    # bytes, their backward residuals, and the decode cross-KV cache by
    # heads/kv_heads (ops/layers.py dot_product_attention).  0 = full
    # multi-head (reference parity).
    fusion_cross_attn_kv_heads: int = 0
    fusion_moe_aux_weight: float = 0.01  # Switch load-balance loss weight
    # GPipe pipeline parallelism for the fusion stack (TPU-native
    # extension; the reference is DP-only, SURVEY.md §2.3).  >0 shards
    # the fusion layers into that many stages over the mesh `pipe` axis
    # (parallel/pipeline.py): the layer loop becomes one
    # shard_map+ppermute+scan program, composed with the data axis.
    # Requires fusion_layers % stages == 0 and a mesh built with
    # make_mesh(n_pipe=stages); incompatible with fusion_moe_experts.
    fusion_pipeline_stages: int = 0
    # microbatch count M (bubble (S-1)/(M+S-1)); 0 = auto (largest
    # divisor of the batch <= 2*stages)
    fusion_pipeline_microbatches: int = 0
    # interleaved (virtual-stage) schedule: V chunks per device assigned
    # stride-S, bubble shrinks to (S-1)/V chunk-times (Megatron-style).
    # Requires fusion_layers % (stages * V) == 0.
    fusion_pipeline_interleave: int = 1
    audio_hidden: int = 768
    audio_layers: int = 12
    audio_heads: int = 12
    audio_intermediate: int = 3072

    # regularisation / compute policy
    dropout: float = 0.1
    # activation checkpointing: torch.utils.checkpoint per layer of the
    # encoders remat_scope names (all, vision, text, audio, fusion, none);
    # remat_policy (a jax.checkpoint policy) is read and ignored by the port
    checkpointing: bool = False
    remat_scope: str = "all"
    remat_policy: str = ""
    # sequence parallelism: the fusion residual stream split over the model
    # axis between layers (parallel/activations.py); across processes with
    # model_shards > 1, a no-op in one process
    sequence_parallel: bool = False
    dtype: str = "bfloat16"  # activation dtype; params stay fp32
    # TPU-only knobs, read and ignored by the port (PERF.md lists them): the
    # port keeps attention logits in fp32 whatever attention_logits_dtype
    # says, uses one attention layout, and has no gelu backward stash
    attention_logits_dtype: str = "bfloat16"
    attention_layout: str = "bshd"
    gelu_stash_dtype: str = "none"
    # split input pipeline: ship clip-span waveforms (mel on the device,
    # data/fbank.py) and raw uint8 frames (normalised on the device)
    device_fbank: bool = True
    uint8_pixels: bool = True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class DatasetConfig:
    """One dataset inside a training/eval mix (reference data_cfg.datasets[])."""

    name: str = ""
    ids_path: str = ""
    txt: str = ""
    video: str = ""
    audio: str = ""
    datatype: str = "video"  # video | image | audio-only handled via task
    video_transforms: str = "none"  # none | crop_flip


@dataclass
class DataFlowConfig:
    """One entry of data_cfg.train / data_cfg.val (a task + loader params)."""

    datasets: List[DatasetConfig] = field(default_factory=list)
    task: str = ""
    batch_size: int = 64
    epoch: int = 1
    n_workers: int = 4
    video_sample_num: int = 4
    audio_sample_num: int = 1
    max_txt_len: int = 30
    name: str = ""  # eval entries carry flat fields; name used for logging


@dataclass
class TrainConfig:
    """Optimisation / loop hyper-parameters (reference argparse + JSON)."""

    output_dir: str = ""
    learning_rate: float = 1e-4
    clip_lr: float = 5e-7
    clip_lr_text: float = 5e-7
    new_lr: float = 0.0
    decoder_lr: float = -1.0
    new_params_name: List[str] = field(default_factory=list)
    optim: str = "adamw"
    adam_mu_dtype: str = "float32"  # first-moment dtype
    adam_nu_dtype: str = "float32"  # second-moment dtype
    # dtype the parameter gradients are cast to before the optimizer chain
    grad_dtype: str = "float32"
    # jax PRNG implementation of the JAX package's training runs (TPU-only;
    # the port draws from explicit torch.Generators)
    prng_impl: str = "rbg"
    betas: Tuple[float, float] = (0.9, 0.98)
    weight_decay: float = 0.01
    grad_norm: float = 5.0
    warmup_ratio: float = 0.1
    scheduler: str = "warmup_linear"
    num_train_steps: int = 0
    gradient_accumulation_steps: int = 1
    dataset_mix_type: str = "random"  # random | accum (round-robin)
    train_inner_steps: int = 1  # steps fused per jit call (TPU-only; ignored by the port)
    model_shards: int = 1  # model axis size (mesh = data x model): tensor, expert and sequence parallelism
    prefetch: bool = True  # keep one device batch in flight (H2D overlap)
    zero_optimizer: bool = False  # ZeRO-1: shard the optimizer state over the data axis
    # ZeRO-3-style fully-sharded params (FSDP): every large param leaf
    # shards one free dim over `data`; GSPMD all_gathers at use sites and
    # reduce-scatters grads, moments inherit the layout — param + grad +
    # optimizer memory drop by the DP degree (parallel/partition.py).
    fsdp: bool = False
    seed: int = 42
    valid_steps: int = 1000
    valid_freq: int = 10
    # caption-benchmark submission mode: '' | 'coco' | 'nocaps' | 'vatex'.
    # Reference flags --coco_submit/--nocaps_submit/--vatex_submit
    # (test.py:136-236): dump server-format submission.json instead of
    # computing local metrics.
    submit_format: str = ""
    save_best: bool = False
    remove_before_ckpt: bool = True
    # save returns once the state is snapshotted to host memory and a
    # background thread writes it (train/checkpoints.py; the JAX package's
    # orbax AsyncCheckpointer)
    async_checkpoint: bool = False
    resume: bool = False
    zero_shot: bool = False
    first_eval: bool = True
    pretrain_dir: Optional[str] = None
    # load this checkpoint step from pretrain_dir instead of the latest
    # (reference --pretrain_step, train_utils.py:120-121)
    pretrain_step: Optional[int] = None
    checkpoint: Optional[str] = None
    # NOTE: the reference's `fp16` flag (apex AMP O2) maps to the model's
    # activation dtype here; load_config translates fp16 -> dtype
    # (true -> bfloat16, false -> float32) when dtype is not given.


@dataclass
class Config:
    """Top-level config: model + train + data mix."""

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data_train: List[DataFlowConfig] = field(default_factory=list)
    data_val: List[DataFlowConfig] = field(default_factory=list)


# ---------------------------------------------------------------------------
# JSON / CLI loading with reference-compatible flat-key layout
# ---------------------------------------------------------------------------

_MODEL_KEYS = {f.name for f in dataclasses.fields(ModelConfig)}
_TRAIN_KEYS = {f.name for f in dataclasses.fields(TrainConfig)}


def _coerce(value: Any, typ: Any) -> Any:
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "y")
    if typ in (int, float) and isinstance(value, str):
        return typ(value)
    if typ is Tuple[float, float] and isinstance(value, (list, tuple)):
        return tuple(float(v) for v in value)
    return value


def _dataset_cfg(d: Dict[str, Any]) -> DatasetConfig:
    known = {f.name for f in dataclasses.fields(DatasetConfig)}
    return DatasetConfig(**{k: v for k, v in d.items() if k in known})


def _flow_cfg(d: Dict[str, Any]) -> DataFlowConfig:
    known = {f.name for f in dataclasses.fields(DataFlowConfig)}
    kw = {k: v for k, v in d.items() if k in known and k != "datasets"}
    datasets = [_dataset_cfg(x) for x in d.get("datasets", [])]
    if not datasets:
        # eval entries in the reference configs are flat dataset+flow dicts
        ds_known = {f.name for f in dataclasses.fields(DatasetConfig)}
        ds = {k: v for k, v in d.items() if k in ds_known}
        if ds.get("ids_path") or ds.get("txt"):
            datasets = [_dataset_cfg(ds)]
    return DataFlowConfig(datasets=datasets, **kw)


def load_config(
    json_path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Config:
    """Build a Config from (defaults <- JSON file <- overrides).

    ``overrides`` uses the same flat key space as the reference CLI, plus the
    convenience keys (``train_batch_size``, ``train_video_sample_num``,
    ``test_video_sample_num``, ...) that mutate the nested data config
    (reference: train_utils.py:59-112).
    """
    flat: Dict[str, Any] = {}
    data_cfg: Dict[str, Any] = {}
    if json_path:
        with open(json_path) as f:
            raw = json.load(f)
        data_cfg = raw.pop("data_cfg", {})
        flat.update(raw)
    if overrides:
        flat.update({k: v for k, v in overrides.items() if v is not None})
        if "data_cfg" in flat:
            data_cfg = flat.pop("data_cfg")

    # reference `fp16` (apex AMP) -> activation dtype, unless dtype given
    if "fp16" in flat:
        fp16 = flat.pop("fp16")
        if isinstance(fp16, str):
            fp16 = fp16.lower() in ("1", "true", "yes")
        flat.setdefault("dtype", "bfloat16" if fp16 else "float32")

    model_kw, train_kw = {}, {}
    model_fields = {f.name: f for f in dataclasses.fields(ModelConfig)}
    train_fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    extra: Dict[str, Any] = {}
    for k, v in flat.items():
        if k in _MODEL_KEYS:
            model_kw[k] = _coerce(v, model_fields[k].type)
        elif k in _TRAIN_KEYS:
            train_kw[k] = _coerce(v, train_fields[k].type)
        else:
            extra[k] = v

    cfg = Config(
        model=ModelConfig(**model_kw),
        train=TrainConfig(**train_kw),
        data_train=[_flow_cfg(d) for d in data_cfg.get("train", [])],
        data_val=[_flow_cfg(d) for d in data_cfg.get("val", [])],
    )
    _apply_convenience_overrides(cfg, extra)
    # eval cadence from valid_freq when valid_steps not given explicitly
    # (reference: train_utils.py:512 unconditionally derives
    # valid_steps = num_train_steps // valid_freq - 1)
    if (
        "valid_steps" not in train_kw
        and cfg.train.num_train_steps > 0
        and cfg.train.valid_freq > 0
    ):
        cfg.train.valid_steps = max(
            cfg.train.num_train_steps // cfg.train.valid_freq - 1, 1
        )
    return cfg


# convenience flat flags -> nested data config mutation
# (reference: train_utils.py:59-112 `initialize`)
_TRAIN_FLOW_MAP = {
    "train_batch_size": "batch_size",
    "train_video_sample_num": "video_sample_num",
    "train_audio_sample_num": "audio_sample_num",
    "train_epoch": "epoch",
    "train_task": "task",
}
_VAL_FLOW_MAP = {
    "test_batch_size": "batch_size",
    "test_video_sample_num": "video_sample_num",
    "test_audio_sample_num": "audio_sample_num",
    "test_task": "task",
}
_TRAIN_DS_MAP = {"train_id": "ids_path", "train_txt_mapper": "txt"}
_VAL_DS_MAP = {"test_id": "ids_path", "test_txt_mapper": "txt"}


def _apply_convenience_overrides(cfg: Config, extra: Dict[str, Any]) -> None:
    def setflows(flows: Sequence[DataFlowConfig], key: str, value: Any) -> None:
        for fl in flows:
            setattr(fl, key, value)

    for k, v in extra.items():
        if v in (None, "", -1):
            continue
        if k in _TRAIN_FLOW_MAP:
            setflows(cfg.data_train, _TRAIN_FLOW_MAP[k], v)
        elif k in _VAL_FLOW_MAP:
            setflows(cfg.data_val, _VAL_FLOW_MAP[k], v)
        elif k in _TRAIN_DS_MAP:
            for fl in cfg.data_train:
                for ds in fl.datasets:
                    setattr(ds, _TRAIN_DS_MAP[k], v)
        elif k in _VAL_DS_MAP:
            for fl in cfg.data_val:
                for ds in fl.datasets:
                    setattr(ds, _VAL_DS_MAP[k], v)
        # unknown keys ignored (parity with argparse ignoring unknowns in JSON)


# architecture keys copied from a pretrain run's hps.json when finetuning
# from --pretrain_dir (reference: train_utils.py:136-144 cover_cfg; the two
# reference keys with no counterpart here — has_vafusion_encoder,
# task_pormpt_as_text [sic] — are dead in the reference as well)
PRETRAIN_COVER_KEYS = (
    "audio_melbins", "audio_patch_size", "audio_mean", "audio_std",
    "audio_frame_shift", "audio_target_length", "video_encoder_type",
    "txt_encoder_type", "multimodal_encoder_type", "audio_encoder_type",
    "caption_type", "share_txt_and_multimodal", "contra_type",
    "multimodal_use_cross_attn", "fineweight_type", "late_fusion",
    "cross_attn_type", "use_task_prompt",
)


def inherit_pretrain_config(cfg: Config) -> list:
    """Copy architecture keys from the pretrain run's hps.json onto cfg.model
    so a finetune cannot silently build a mismatched architecture.  Returns
    the list of keys actually inherited (for logging)."""
    import os

    pdir = cfg.train.pretrain_dir
    if not pdir:
        return []
    for cand in (os.path.join(pdir, "hps.json"), os.path.join(pdir, "log", "hps.json")):
        if os.path.exists(cand):
            with open(cand) as f:
                hps = json.load(f)
            model_hps = hps.get("model", hps)  # our nested dump or flat
            inherited = []
            for k in PRETRAIN_COVER_KEYS:
                if k in model_hps and getattr(cfg.model, k, None) != model_hps[k]:
                    setattr(cfg.model, k, model_hps[k])
                    inherited.append(k)
            return inherited
    return []


def config_to_json(cfg: Config) -> str:
    """Serialize for the `hps.json` dump (reference: train.py:70-71)."""

    def enc(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        raise TypeError(type(o))

    return json.dumps(dataclasses.asdict(cfg), indent=2, default=enc)
