#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``valor_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in the order 1-8, 10-14, 7b, 15, 16, 7c, 17, 18, 20, 21, 22, f, a-e, 19, 9; any
failure ends the run with a traceback and a non-zero exit code, and no result
line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     and the build of every kernel from ``valor_tpu_torch/csrc``: one nvcc a
     source and g++ for the C++ decoder (``csrc/host``), all started together;
  2. the LayerNorm kernel against its plain version at the shapes the serving
     and pretraining paths give it (and VALOR-large's ViT-L rows at C 1024,
     VideoSwin-B's first stage at C 128 and its last merge at C 2048),
     bf16 -> bf16 and f32 -> f32 (and the mixed
     pairs at the fusion shape), with its device time (from CUDA graph
     replays) beside the plain version's, ``F.layer_norm``'s and the bytes
     bound, and the host cost a call of the wrapper and of ``F.layer_norm``;
  3. the whole port on the card against the whole port on the CPU: the tiny
     config in fp32 (TF32 off), greedy and beam-3 ``cap%tva`` sequences equal
     token for token, decoder logits within 1e-4;
  4. full-width VALOR-base caption serving (``configs/caption-valor32k.json``,
     bf16, seeded random weights) through ``InferenceEngine``: 48 greedy
     requests from 8 threads, then one beam-3 batch of 4; every row equal to a
     direct ``Generator.generate`` at its bucket size, and the kernel launch
     count equal to the number of LayerNorms the served batches run;
  5. the HTTP frontend with the image featurizer: /healthz, four POST
     /generate with JPEG paths, /stats, a 400 case, and two requests with a
     question (a short one and one of 40 ids, which no pad cuts);
  6. the LayerNorm backward kernel against its plain version at the shapes
     the pretraining step gives it at batch 32 (and a ragged and a 4096-wide
     one, and phase 2's ViT-L and VideoSwin rows), bf16 and f32 (and x and
     dy in different types at the fusion shape), with its device time beside
     the plain version's,
     the ATen backward of ``F.layer_norm`` (``library_ms``) and the bytes
     bound, the host cost a call of the wrapper and of the ATen backward,
     the grid (one launch a call, one [2, C] partial a block), and dw and db
     the same bits over two calls;
  7. one training step of the tiny config on the card against the same step
     on the CPU, fp32 with TF32 off: losses within 1e-4, every parameter
     gradient and every updated parameter within the stated tolerances;
  8. full-width VALOR-base pretraining (``configs/pretrain-valor-base.json``,
     ``pt_contra%tva%tv%ta_caption%tva%tv%ta``, bf16, seeded random weights)
     through ``Trainer.run`` at batch 32: one warm-up step and ten timed
     steps on one repeated synthetic batch; every loss finite, the last
     step's total loss below the first's, and the forward and backward kernel
     launches equal to the LayerNorms each step runs;
  10. the fine-score kernel (K2) against its plain version at the MSR-VTT
     1k-A shapes of the four fine groups (tva, tv, vta, atv; 1000 x 1000) and
     the MSCOCO 5k gallery (25000 captions x 5000 images, V = 1), and tva at
     VALOR-large's D = 768, fp32 and tva also bf16, plus the three edge cases
     of tests/test_pallas.py at D = 512 and negative_rows at D = 4096 (fp32
     and bf16),
     with its device time (CUDA graph replays) beside the plain version's, the
     fp32 GEMM of the same product (``torch.matmul``, TF32 off; a yardstick,
     not the same function; for fp32 also one TF32 GEMM, for bf16 the bf16
     GEMM), the bounds (fp32:
     the FMA units' and 3xTF32's, the faster one the bound), the share of
     the bound, the TFLOP/s reached and the rate at which the kernel's tiles
     read their operands, and the wrapper's host cost a call;
  11. the tiny config on the card against the CPU, fp32 with TF32 off: one
     ``ret%tva%tv`` training step (losses, gradients and updated parameters to
     phase 7's tolerances) and ``validate_ret`` over a 12-item gallery (score
     matrices within phase 10's tolerance, reports equal);
  12. full-width VALOR-base retrieval (``configs/retrieval-msrvtt.json``,
     ``ret%tva%tv``, bf16, seeded random weights) through ``Trainer.run`` at
     the train flow's batch 64, 4 frames and 2 clips: one warm-up step and ten timed steps on one repeated synthetic
     batch, then the trainer's final evaluation, ``validate_ret`` over a
     seeded synthetic gallery of 1000 items (MSR-VTT 1k-A's size; 8 frames,
     2 clips, 32 tokens); every loss finite, the contrastive loss falling,
     every report key finite, K2 launched once a fine group, the report and
     the score matrices equal to those of the chunked plain path on the same
     features, the LayerNorm launches those of the towers the path runs, and
     ``va`` self-retrieval at R@1 = 100 through K2;
  13. exact resume on the card: the tiny config trained for 6 updates of 2
     micro-batches in one run, and in a run stopped after micro-batch 5, saved,
     restored and continued, under ``torch.use_deterministic_algorithms``
     (warn_only): the restored state equal to the saved one, and the two runs'
     final parameters and optimizer state the same bits unless an op without a
     deterministic version is named (then listed, and the bits reported);
  14. training from disk through ``python -m valor_tpu_torch.cli.train``'s
     ``main`` at the full width of ``configs/retrieval-msrvtt.json`` (batch 64,
     4 frames, 2 clips, crop_flip, device fbank, uint8 pixels, bf16; seeded
     random weights): a seeded MSR-VTT-shaped dataset written to a temporary
     directory (320 training ids, 128 evaluation ids, 40 JPEG frames of 320 x
     240 and a 10 s 22050 Hz WAV an id, one in ten without audio), run 1 of ten
     steps with its evaluations and saves at steps 5 and 10, run 2 resumed to
     step 20, both with ``--async_checkpoint true``; the restored state equal
     to the saved one bit for bit, the writes at the steps saved, losses
     finite, reports finite, the kernel launches those of the path, run 2's
     state saved once more with the next update queued at once and the
     checkpoint's payload equal bit for bit to the state before the update
     (``check_async_snapshot``), and the device fbank of a batch against
     ``fbank_np``; it prints samples/s
     from disk against phase 12's synthetic rate, the data-stall share, peak
     memory, the seconds each save blocked the trainer (the first, which
     allocates the pinned host buffers, apart), each background write's
     seconds, the step times while a write ran and after, restore seconds and
     validation items/s;
  7b. the tiny config on the card against the CPU for the caption and QA
     slice, fp32 with TF32 off: one ``cap%tva`` and one ``qa%tva`` training
     step (a multi-answer batch with ``tile_index`` and ``answer_weights``) to
     phase 7's tolerances, and greedy and beam-3 captions and greedy answers
     decoded from clip-span waveforms through the device fbank, equal token
     for token;
  15. caption finetuning from disk through ``cli.train``'s ``main`` at the full
     width of ``configs/caption-msrvtt.json`` (``cap%tva``, batch 64, 4
     frames, 1 clip, bf16; from ``--checkpoint`` a run of the sharp init law's
     seeded weights, whose captions depend on their media, as phases 17, 20
     and 21 need; ``cli.train`` alone draws the JAX package's law): a seeded MSR-VTT-shaped
     dataset written to a temporary directory (320 training ids with 20
     captions, 128 evaluation ids with 20 references, the media of phase 14's
     shape, written once for phases 15 and 16), the config's evaluation
     before training, 10 steps and the final validation (beam 3, 30 tokens);
     losses finite, the report's Bleu_4, CIDEr, METEOR and ROUGE_L finite, a
     step dump of every evaluation id, the LayerNorm launches those of the
     path and no fine-score launch; it prints samples/s, the data-stall
     share, peak memory, captions/s of the validation and the share of it in
     ``caption_eval`` (and ``meteor_lite`` within it);
  16. QA finetuning from disk the same way at the full width of
     ``configs/qa-msrvtt.json`` (``qa%tva``; 1-3 MSR-VTT-QA pairs an id; the
     validation at 8 frames, greedy, 10 tokens, one row a question): losses
     finite, ``accuracy`` present, the ground-truth and prediction dumps one
     row a question, the launches those of the path; it prints samples/s,
     the data stall, peak memory, the text and media rows of the training
     batches and answers/s of the validation;
  7c. the tiny config on the card against the CPU for the SCST, task-prompt
     and context-K/V slice, fp32 with TF32 off: one ``Trainer.scst_step`` of
     ``cap%tva%tv`` with the same greedy and sampled rollouts patched in on
     both devices (rewards equal, losses within 1e-4, gradients and updated
     parameters to phase 7's tolerances); greedy and beam-3 captions with
     ``multimodal_use_cross_attn=False`` and the caption prompt through the
     context-K/V decode, equal token for token; one prompted
     ``pt_contra%tva%tv_caption%tva%tv`` step to phase 7's tolerances; one
     caption served with the caption prompt equal to a direct
     ``Generator.generate``;
  17. SCST caption finetuning from disk through ``cli.train``'s ``main`` at the
     full width of ``configs/caption-msrvtt.json`` with ``--scst_finetuning
     true`` and ``--pretrain_dir`` phase 15's run, on phase 15's dataset: six
     SCST steps, then the final validation; the restored weights equal phase
     15's saved ones, losses and rewards finite, every fusion parameter with a
     gradient and the towers without, the LayerNorm launches those of the
     path and no fine-score launch; it prints samples/s, a step's seconds by
     part (media encode, greedy rollout, sampled rollout, host reward,
     update), the mean reward and alpha, the data stall, peak memory,
     captions/s of the validation and the ``Scorer``'s construction time;
  18. prompted pretraining from disk through ``cli.train``'s ``main``:
     ``configs/pretrain-valor-base.json``'s first train flow with
     ``use_task_prompt`` on, at batch 32, on phase 14's dataset, and a ``pt``
     evaluation flow over its 128 evaluation ids: ten steps, then
     ``validate_pt``; the batches carry the task's prompt arrays, losses and
     report finite, one fine-score launch a fine contrastive group, the
     LayerNorm launches those of the path; it prints samples/s from disk
     against phase 8's in-memory rate, ``validate_pt`` items/s and peak memory,
     and which decoder ran (``transforms`` none: the C++ decoder of
     ``data/native.py`` for every item where it builds, else PIL for all);
  19. the C++ decoder (``csrc/host/valor_native.cpp``, built with the host
     compiler) against the PIL route on phase 14's 128 evaluation ids (8
     frames of 320 x 240 each, to 224 px, uint8): whether it built (else the
     compiler's message), frames/s of each route single-threaded and from 8
     threads, and their agreement (correlation per item above 0.98);
  20. video in: four synthetic 10 s clips (320 x 240 at 4 fps with a tone;
     encoded by ffmpeg where there is one, else written for a stand-in
     ``ffmpeg`` put at the front of ``PATH``), ``python -m
     valor_tpu_torch.cli.extract`` over them (the layout read back as
     ``cli.train`` reads it), then ``cli.infer``'s ``main`` on one clip at the
     full width of ``configs/caption-msrvtt.json`` with ``--checkpoint`` phase
     15's caption run, at beam 3 and with a question: the restored weights
     equal the run's, each caption equal to an in-process
     ``Generator.generate`` on the same pixels, the LayerNorm launches those
     of one decode; it prints the seconds of extraction, featurizing, model
     build with restore, and generation;
  21. serving video: ``cli/serve.py``'s ``serve`` in this process at the full
     width of ``configs/caption-valor32k.json`` with ``--checkpoint`` phase
     15's run, bucket 16, the ``video_path`` featurizer at 8 frames and 2
     clips: 16 concurrent ``video_path`` requests, 2 with questions, and a
     missing video (a 400); every served caption equal to an in-process one
     at its bucket size, the launches those of the batches; it prints latency
     p50 and p95 at the client, captions/s and the featurizer's share;
  22. weights in: synthetic files in the released layouts at VALOR-base width
     (a CLIP ViT-B/16 JIT archive, a BERT-base ``.bin``, an AudioSet AST
     checkpoint, a whole VALOR ``.pt``), then ``cli.train`` on phase 15's
     dataset for 5 steps with ``$VALOR_PRETRAINED_DIR`` at the encoder files,
     and again with ``--checkpoint`` the ``.pt``: every converted tensor in
     the model after the restore and traced to its source, the first loss
     finite, K1 both ways as counted; it prints each conversion's seconds and
     peak resident size, each taken in a fresh process that only converts;
  a. the tiny config's MoE (4 experts, every other layer), grouped-query
     (one K/V head) and VideoSwin (``videoswin_tiny_test``, BERT text)
     variants on the card against the CPU, fp32 with TF32 off: one
     pretraining step each to phase 7's tolerances (with ``moe_aux``), and
     phase 3's greedy and beam-3 sequences and decoder logits;
  b. MoE pretraining from disk: ``configs/pretrain-valor-base-moe.json``'s
     first flow (8 experts, top-2, every other fusion layer) through
     ``cli.train`` on phase 14's dataset at batch 32, 5 steps and
     ``validate_pt``, as phase 18 without prompts; it prints samples/s against
     phase 18's, peak memory, ``moe_aux`` a step over its weight and each MoE
     layer's share of dropped choices, over all tokens and over non-pad
     tokens;
  c. VALOR-large pretraining from disk: ``configs/pretrain-valor-large.json``
     (ViT-L/14, CLIP-L text, task prompts) the same way, at the largest batch
     of 64, 32, 16 and 8 whose synthetic training step fits on the card;
  d. VideoSwin caption finetuning from disk: ``configs/caption-msrvtt.json``
     with ``videoswin_base_k600_22k`` video and BERT text on phase 15's
     dataset, as phase 15 with 5 steps and one validation (beam 3), at the
     config's batch 64 or the largest that fits; it prints the Swin widths
     that K1 saw and its launches at each;
  e. grouped-query serving: ``configs/caption-valor32k.json`` with 4 of 12
     cross-attention K/V heads through phase 4's checks at bucket 16, with the
     cross-K/V cache's bytes against 12 heads; and ``configs/caption-mscoco.json``
     at 392 px (577 tokens a frame) in memory, phase 8's way: ``cap%tv`` at
     batch 64 with one frame, one warm-up and ten timed steps;
  f. data parallelism across processes (``valor_tpu_torch/parallel``), one
     card, in one launch of ``python -m torch.distributed.run --standalone
     --nproc_per_node 2`` with ``--dist_backend gloo``, both ranks on the
     card: (i) the tiny config, fp32, TF32 off: the 2 ranks of 4 rows against
     1 process of 8 for one ``pt`` step with dropout and masks drawn (every
     loss, the grad norm and every updated parameter within 1e-5) and
     ``validate_ret`` over 9 items (reports equal); then, in the same
     launch, three ``cli.train`` flows in turn: (ii)
     ``configs/pretrain-valor-base.json``'s first flow, global batch 32, 2 steps, on a dataset written here that
     draws nothing at random on the host (96 training ids, one caption an id,
     4 frames and a 4 s WAV), ``validate_pt`` over its 64 evaluation ids, no
     checkpoint written ((v) writes one);
     per rank and in all samples/s (two processes sharing one card: no
     scaling), peak memory, the gradient all-reduce's ms a step and bytes, K1
     and K2 launches as counted, equal losses and reports; (v) the same with
     ``--zero_optimizer true --async_checkpoint true`` (ZeRO-1): its losses
     within 1e-5 of (ii)'s on the same batches and draws (both under
     ``torch.use_deterministic_algorithms``), each rank holding less optimizer
     state than (ii)'s, the reduce-scatter and gathers timed, the two ranks'
     final states equal; (iv) ``configs/caption-msrvtt.json`` with
     ``--scst_finetuning true --pretrain_dir`` phase 15's run, 3 SCST steps at
     a global batch of 32 and 30 tokens: the caption run's weights at the
     first step, the same rewards and alpha on both ranks, finite losses, K1
     launches as ``expected_scst_ln_launches`` gives them a rank; a step's
     seconds by part (encode, rollouts, gather, reward, update); (iii) the
     pretraining path at ``--nproc_per_node 1 --dist_backend nccl`` and in a
     plain process, each resuming (v)'s checkpoint for 3 more steps with
     ``--zero_optimizer true`` (which one rank, as one process, reads as the
     replicated optimizer): both restore the state the two ZeRO ranks saved,
     bit for bit (``state_digest``), the NCCL rank's losses within 1e-6 of the
     plain process's, and the NCCL all-reduce's ms a step.  Each rank is
     this script's ``--ddp-worker``, which runs the flows through
     ``cli.train``'s ``main`` in one process group, counts each flow's
     launches and times its collectives; a rank's failure or the launcher's
     nonzero exit fails the run.  The same launch then runs the parameter
     axes: (vi) (ii)'s training without its validation, with ``--fsdp true``
     (data 2 x model 1), deterministic: every loss and grad norm within 1e-5
     of (ii)'s, each rank's parameter, gradient and optimizer bytes against
     (ii)'s, the peak, the gathers' and reduce-scatters' ms and bytes a step,
     the launches; it writes one whole checkpoint, which the plain process of
     (iii) restores to (vi)'s ``state_digest``; (vii) (ii) with
     ``--model_shards 2`` (data 1 x model 2, tensor parallelism; the global
     batch of 32 on both ranks): the first step's losses within 2e-2 of (ii)'s
     and its grad norm within 5e-2 (bf16), finite losses after, the model axis's all-reduces (count, ms and
     bytes a step), each rank's parameter bytes, the peak, ``validate_pt``'s
     reports equal on both ranks, the launches; (viii)
     ``configs/pretrain-valor-base-moe.json``'s first flow with
     ``--model_shards 2 --sequence_parallel true`` (data 1 x model 2: expert
     parallelism, 4 of 8 experts a rank in each of the 6 MoE layers, sequence
     parallelism of the 42-token fusion stream and tensor parallelism
     together), 2 steps at a global batch of 32 and ``validate_pt`` on its 64
     ids: both counts (``expert_sharding_applied``,
     ``sequence_sharding_applied``) above 0 on each rank, equal losses on both
     ranks, the first step's losses with ``moe_aux`` within 2e-2 of a plain
     process running the same flow on the same batches (its grad norm within
     5e-2), ``validate_pt``'s reports equal on both ranks, the launches; the
     model axis's collectives (count, ms and bytes a step), the peak and the
     step time; (ix) (ii) with ``--fusion_pipeline_stages 2`` (data 1 x pipe
     2: 16 rows a rank at the towers, the 12 fusion layers in 2 stages of 6,
     4 microbatches of 8 rows, GPipe), 2 steps and ``validate_pt`` on the 64
     ids: the stack pipelined on both ranks in every caption group's pass,
     equal losses and reports on both ranks, the first step's losses within
     2e-2 of (ii)'s on the same batches (grad norm within 5e-2), K1 launches
     of a pipe rank (its stage's layers once a microbatch; the validation runs
     the stack whole) and K2's; the transport of the stage sends (gloo through
     pinned host memory on one card), the stage sends, the pipe's gathers and
     hand-backs (count, bytes and ms a step), the bubble measured by timing
     each block between two synchronisations, the step time and the peak;
  9. every shape that the main paths of phases 4, 8, 12, 14-18, 20-22, b-e
     and f handed each kernel is held against the plain version: listed where
     phase 2, 6 or 10 compared it, compared here where they did not.

It prints a ``{"kernels": [...]}`` line (launches by path: serving,
serve_video, gqa_serving, pretraining, retrieval, cli_train, cap_train,
qa_train, scst_train, infer, weights_train, pt_prompt_train, moe_train,
large_train, swin_cap_train, mscoco_train, ddp_train, ddp_zero_train,
ddp_scst_train, ddp_fsdp_train, ddp_tp_train, ddp_ep_sp_train and
ddp_pp_train (both ranks of phase f (ii), (v), (iv), (vi), (vii), (viii) and
(ix)) and ddp_nccl_train (phase
f (iii)'s NCCL process)), the card's name and power
limit before it, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero without printing them where CUDA is unavailable.

    python3 chip_smoke.py --phase18

runs phases 1, 8 and 18 alone in one process, on phase 14's dataset written
for it (no training run on it): phase 18's rate apart from the phases that
precede it in a whole run.  It prints no result line.

    python3 chip_smoke.py --families

runs phases 1 and a-e alone, on phase 14's and 15's datasets written for
them, then phase 9 over the shapes they handed the kernels.  It prints no
result line.

    python3 chip_smoke.py --ddp

runs phases 1 and f alone, on a caption dataset (64 training and 8
evaluation ids) and a sharp-law caption run written for it, then phase 9 over
the shapes phase f handed the kernels.  It prints no result line.

    python3 chip_smoke.py --tp-dtypes

runs phase f (ii) and (vii) alone at a global batch of 16 (no validation),
each in fp32 and in bf16, in one two-rank launch, and prints each flow's
losses: tensor parallelism against the replicated ranks with and without
bf16's rounding.  It prints no result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# bf16 tolerance: one ulp relative (2**-7 of the value, 8 significand bits),
# plus the fp32 one (1e-5 absolute) where w*xhat and b cancel to near zero
BF16_ULP = 2.0 ** -7
F32_ABS = 1e-5
LN_SHAPES = [  # name, rows, cols, eps: what the serving and pretraining paths hand the forward
    ("vit_b16_bucket16_8frames", 16 * 8 * 197, 768, 1e-5),  # also ViT at batch 32 x 4 frames
    ("ast_bucket16_2clips", 16 * 2 * 129, 768, 1e-12),  # also AST at batch 32 x 1 clip
    ("decode_step_bucket16", 16 * 32, 768, 1e-12),
    ("decode_step_beam3", 48 * 32, 768, 1e-12),
    ("clip_text_32x40", 32 * 40, 512, 1e-5),
    ("fusion_32x40", 32 * 40, 768, 1e-12),
    ("ragged", 1000, 500, 1e-5),
    ("vit_l14_32x4frames", 32 * 4 * 257, 1024, 1e-5),  # VALOR-large's video tower
    ("swin_b_stage0_64x4frames", 64 * 4 * 56 * 56, 128, 1e-5),  # VideoSwin-B's first stage
    ("swin_b_merge2_64x4frames", 64 * 4 * 7 * 7, 2048, 1e-5),  # its last patch merge
]
LN_BWD_SHAPES = [  # name, rows, cols, eps: what the pretraining step at batch 32 hands the backward
    ("vit_b16_32x4frames", 32 * 4 * 197, 768, 1e-5),
    ("clip_text_32x40", 32 * 40, 512, 1e-5),
    ("ast_32x1clip", 32 * 129, 768, 1e-12),
    ("fusion_32x40", 32 * 40, 768, 1e-12),
    ("ragged", 1000, 500, 1e-5),
    ("wide", 2048, 4096, 1e-5),
    ("vit_l14_32x4frames", 32 * 4 * 257, 1024, 1e-5),
    ("swin_b_stage0_64x4frames", 64 * 4 * 56 * 56, 128, 1e-5),
    ("swin_b_merge2_64x4frames", 64 * 4 * 7 * 7, 2048, 1e-5),
]
# (x dtype, out dtype for the forward or dy dtype for the backward): both kernels
# take each type on either side; the matched pairs at every shape, the mixed
# ones at the fusion shape
MATCHED = [("bfloat16", "bfloat16"), ("float32", "float32")]
MIXED = [("float32", "bfloat16"), ("bfloat16", "float32")]
PT_TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"
RET_TASK = "ret%tva%tv"
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 on the tensor cores (fp32 accumulation), dense
TF32_FLOPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
FS_SHAPES = [  # name, A, B, T, V, D: what the retrieval evaluation hands the fine-score kernel
    ("msrvtt_tva", 1000, 1000, 32, 10, 512),  # captions x (8 frames + 2 clips)
    ("msrvtt_tv", 1000, 1000, 32, 8, 512),
    ("msrvtt_vta", 1000, 1000, 8, 34, 512),  # frames x (32 tokens + 2 clips)
    ("msrvtt_atv", 1000, 1000, 2, 40, 512),  # clips x (32 tokens + 8 frames)
    ("mscoco_5k", 25000, 5000, 32, 1, 512),  # 5 captions an image, one image token
    ("msrvtt_tva_d768", 1000, 1000, 32, 10, 768),  # VALOR-large's CLIP-L embedding
]
FS_EDGES = [  # name, A, B, T, V, D, dtype: the cases of tests/test_pallas.py::TestFineScoreFused, at
    # D = 512, and negative_rows at D = 4096 in both types, whose dots' terms all share a sign (no
    # cancellation hides the rounding of the tensor cores' accumulators; bf16 sums a whole dot in
    # one accumulator, the route with the least margin)
    ("unaligned", 9, 21, 7, 5, 512, "float32"), ("negative_rows", 4, 4, 3, 2, 512, "float32"),
    ("masked_tokens_zero", 5, 6, 4, 3, 512, "float32"),
    ("negative_rows", 4, 4, 3, 2, 4096, "float32"), ("negative_rows", 4, 4, 3, 2, 4096, "bfloat16"),
]
# kernel against plain version, on unit-norm features (|dot| <= 1): bf16 products are
# exact in fp32 on the tensor cores, and fp32 features run as 3xTF32 (hi.hi + hi.lo +
# lo.hi of x = hi + lo), whose dropped lo.lo is about 2**-22 of a term, below fp32's own
# rounding of the sum; only the order of the sum differs from the plain version's.  One
# TF32 product (2**-11 a term) would miss this tolerance
# (tests/test_torch_fine_score.py::test_single_tf32_misses_the_tolerance).
FS_TOL = "abs 1e-5 + rel 1e-5"


T0 = time.monotonic()


def log(msg: str) -> None:
    """``msg`` on its own line, after the seconds since the script started."""
    print(f"[{time.monotonic() - T0:7.1f} s] {msg}", flush=True)


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times between two events.  The host
    does not launch the calls one by one, so its cost is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def host_us(fn, iters: int = 50) -> float:
    """Host time of one ``fn()`` call, launched back to back (the launches
    queue on the stream, so the device does not hold the host back)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def tiny_config():
    from valor_tpu_torch.core.config import ModelConfig

    return ModelConfig(
        video_encoder_type="clip_vit_tiny", video_resolution=32,
        audio_melbins=16, audio_target_length=32, audio_patch_size=16,
        fusion_hidden=32, fusion_layers=2, fusion_heads=2, fusion_intermediate=64,
        fusion_vocab=512, audio_hidden=32, audio_layers=2, audio_heads=2,
        audio_intermediate=64, dtype="float32", max_generation_len=6,
    )


def tiny_prompts(task) -> dict:
    """Task-prompt arrays of ``task`` in the layout of ``data/prompts.py``
    ([1, P] ids within the tiny vocabularies; the last prompt padded)."""
    out = {}
    if task.contra_groups:
        out["prompt_tokens_contra"] = np.asarray([[300, 21, 22, 23, 301]], np.int64)
    if task.caption_groups:
        out["prompt_tokens_caption"] = np.asarray([[101, 110, 111, 112, 113, 102]], np.int64)
    for g in task.mlm_groups:
        out[f"prompt_tokens_mlm_{g}"] = np.asarray([[101, 120, 121, 102, 0]], np.int64)
    return out


@contextlib.contextmanager
def record_ln_calls():
    """Yields two sets that fill, inside the block, with the (rows, cols, eps,
    x dtype, out dtype) of every LayerNorm forward call and the (rows, cols,
    eps, x dtype, dy dtype) of every backward call, in any thread.  It wraps
    the two wrappers where the module and the autograd Function look them up,
    and launches nothing and counts nothing itself."""
    from valor_tpu_torch.ops.kernels import layernorm as K

    fwd, bwd = set(), set()
    fwd0, bwd0 = K._fwd, K.layernorm_bwd

    def sig(x, eps, other):
        return (x.numel() // x.shape[-1], x.shape[-1], eps, str(x.dtype)[6:], str(other)[6:])

    def fwd1(x, w, b, eps, out_dtype):
        fwd.add(sig(x, eps, out_dtype))
        return fwd0(x, w, b, eps, out_dtype)

    def bwd1(x, w, eps, dy):
        bwd.add(sig(x, eps, dy.dtype))
        return bwd0(x, w, eps, dy)

    K._fwd, K.layernorm_bwd = fwd1, bwd1
    try:
        yield fwd, bwd
    finally:
        K._fwd, K.layernorm_bwd = fwd0, bwd0


@contextlib.contextmanager
def record_fine_calls():
    """Yields a list that fills, inside the block, with ([A, B, T, V, D,
    dtype], host ms between two synchronisations) of every fine-score kernel
    wrapper call.  It wraps the wrapper where ``tasks.losses`` looks it up, and
    launches nothing and counts nothing itself."""
    import torch

    from valor_tpu_torch.ops.kernels import fine_score as K2

    calls = []
    fn0 = K2.fine_score_fused

    def fn1(fa, fb, ma, mb, wa, wb):
        sync = torch.cuda.synchronize if fa.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn0(fa, fb, ma, mb, wa, wb)
        sync()
        sig = [fa.shape[0], fb.shape[0], fa.shape[1], fb.shape[1], fa.shape[2], str(fa.dtype)[6:]]
        calls.append((sig, (time.perf_counter() - t0) * 1e3))
        return out

    K2.fine_score_fused = fn1
    try:
        yield calls
    finally:
        K2.fine_score_fused = fn0


@contextlib.contextmanager
def record_scores():
    """Yields a list that fills, inside the block, with (group, features,
    score matrix, host time at entry after a synchronisation) of every
    ``retrieval_scores`` call that ``validate_ret`` makes."""
    import torch

    from valor_tpu_torch.eval import validate as V

    calls = []
    fn0 = V.retrieval_scores

    def fn1(model, feats, group, contra_type):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn0(model, feats, group, contra_type)
        calls.append((group, feats, out, t0))
        return out

    V.retrieval_scores = fn1
    try:
        yield calls
    finally:
        V.retrieval_scores = fn0


def chunked_scores(model, feats, group, contra_type):
    """``retrieval_scores`` with the gallery scored by ``fine_score_chunked``,
    the plain path, on whatever device the features are."""
    from valor_tpu_torch.eval import validate as V
    from valor_tpu_torch.tasks import losses as L

    gallery = L.fine_score_gallery
    L.fine_score_gallery = L.fine_score_chunked
    try:
        return V.retrieval_scores(model, feats, group, contra_type)
    finally:
        L.fine_score_gallery = gallery


def check_scores(got, ref, what: str) -> float:
    """``got`` within ``FS_TOL`` of ``ref`` (fp32 tensors on one device); the max abs err."""
    diff = (got.float() - ref.float()).abs()
    if not bool((diff <= 1e-5 + 1e-5 * ref.float().abs()).all()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())} exceeds {FS_TOL}")
    return float(diff.max()) if diff.numel() else 0.0


# -- phase 1 ------------------------------------------------------------------
def phase_card_and_build():
    import torch

    from valor_tpu_torch.data import native
    from valor_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(len(names) + 1) as pool:  # one nvcc a source and g++ for the decoder, side by side
        decoder = pool.submit(native.available)
        list(pool.map(_build.load_library, names))
        built = decoder.result()
    log(f"build: {names} and the decoder ({'built' if built else 'not built'}) in {time.monotonic() - t0:.1f} s")
    return smi


# -- phase 2 ------------------------------------------------------------------
def _ln_inputs(n, c, x_dtype, gen):
    import torch

    dev = torch.device("cuda")
    x = (torch.randn(n, c, device=dev, generator=gen) * 2 + 0.3).to(getattr(torch, x_dtype))
    return x, torch.rand(c, device=dev, generator=gen) + 0.5, torch.randn(c, device=dev, generator=gen)


def check_fwd(x, w, b, eps, out_dtype) -> tuple:
    """The forward kernel against its plain version; (max abs err, tolerance).
    fp32 out: 1e-5 absolute; bf16 out: one bf16 ulp relative plus 1e-5."""
    import torch

    from valor_tpu_torch.ops.kernels import layernorm as K

    y = K.layernorm(x, w, b, eps, out_dtype)
    ref = K.layernorm_plain(x, w, b, eps, out_dtype)
    torch.cuda.synchronize()
    diff = (y.float() - ref.float()).abs()
    err = float(diff.max())
    if out_dtype == torch.float32:
        ok, tol = err <= F32_ABS, "abs 1e-5"
    else:
        scale = torch.maximum(y.float().abs(), ref.float().abs())
        ok, tol = bool((diff <= BF16_ULP * scale + F32_ABS).all()), "1 bf16 ulp + abs 1e-5"
    if not ok:
        raise AssertionError(f"layernorm [{x.shape[0]}, {x.shape[1]}] {x.dtype} -> {out_dtype}, "
                             f"eps {eps}: max abs err {err} exceeds {tol}")
    return err, tol


def phase_layernorm():
    import torch
    import torch.nn.functional as F

    from valor_tpu_torch.ops.kernels import layernorm as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, n, c, eps in LN_SHAPES:
        for xd, od in MATCHED + (MIXED if name == "fusion_32x40" else []):
            x, w, b = _ln_inputs(n, c, xd, gen)
            dtype = getattr(torch, od)
            err, tol = check_fwd(x, w, b, eps, dtype)
            xl, wl, bl = x.to(dtype), w.to(dtype), b.to(dtype)
            row = {
                "shape": f"{name} [{n}, {c}] {xd}" + (f" -> {od}" if od != xd else ""),
                "sig": [n, c, eps, xd, od], "max_abs_err": err, "tol": tol,
                "kernel_ms": graph_ms(lambda: K.layernorm(x, w, b, eps, dtype)),
                "plain_ms": graph_ms(lambda: K.layernorm_plain(x, w, b, eps, dtype)),
                "library_ms": graph_ms(lambda: F.layer_norm(xl, (c,), wl, bl, eps)),
                "kernel_host_us": host_us(lambda: K.layernorm(x, w, b, eps, dtype)),
                "library_host_us": host_us(lambda: F.layer_norm(xl, (c,), wl, bl, eps)),
                "bound_ms": (n * c * (x.element_size() + dtype.itemsize) + 2 * c * 4)
                / HBM_BYTES_PER_S * 1e3,
            }
            rows.append(row)
            log("layernorm " + json.dumps(row))
    return rows


# -- phase 3 ------------------------------------------------------------------
def phase_card_vs_cpu(cfg=None):
    """``cfg`` None is the tiny config; phase a passes its MoE, GQA and VideoSwin variants."""
    import torch

    from valor_tpu_torch.eval.generate import Generator, make_fusion_decoder
    from valor_tpu_torch.models.bridge import init_params, load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or tiny_config()
    sd = init_params(cfg, seed=0, device="cpu")
    models = {"cpu": load_model(cfg, sd, "cpu"),
              "cuda": load_model(cfg, {k: v.cuda() for k, v in sd.items()}, "cuda")}
    rng = np.random.RandomState(0)
    batch = {
        "video_pixels": rng.randint(0, 256, size=(4, 2, 32, 32, 3), dtype=np.uint8),
        "audio_spectrograms": rng.randn(4, 1, 16, 32).astype(np.float32),
    }
    for beam in (1, 3):
        seqs = {d: Generator(m).generate(batch, ("tva",), max_len=6, beam_size=beam)[
            "generated_sequences_tva"].cpu().numpy() for d, m in models.items()}
        if not np.array_equal(seqs["cpu"], seqs["cuda"]):
            raise AssertionError(f"beam {beam}: card {seqs['cuda'].tolist()} != cpu {seqs['cpu'].tolist()}")
        log(f"card vs cpu, beam {beam}: equal sequences {seqs['cuda'].tolist()}")
    buf = torch.from_numpy(rng.randint(106, 512, size=(4, 8))).long()
    buf[:, 0] = 101
    mask = (torch.arange(8)[None] <= 4).float().expand(4, 8)
    logits = {}
    with torch.inference_mode():
        for d, m in models.items():
            v = m.video_fusion_input(m.encode_video(torch.from_numpy(batch["video_pixels"]).to(d)))
            a = m.audio_fusion_input(m.encode_audio(torch.from_numpy(batch["audio_spectrograms"]).to(d)))
            logits[d] = make_fusion_decoder(m, None, v, a)(buf.to(d), mask.to(d)).cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    if err > 1e-4:
        raise AssertionError(f"card vs cpu decoder logits differ by {err} > 1e-4")
    log(f"card vs cpu decoder logits: max abs diff {err:.3g} (tol 1e-4)")
    torch.backends.cudnn.allow_tf32 = True


# -- phase 4 ------------------------------------------------------------------
def _items(cfg, n, frames=8, clips=2, seed=0):
    rng = np.random.RandomState(seed)
    r = cfg.video_resolution
    return [{
        "video_pixels": rng.randint(0, 256, size=(frames, r, r, 3), dtype=np.uint8),
        "audio_spectrograms": rng.randn(clips, cfg.audio_melbins, cfg.audio_target_length).astype(np.float32),
    } for _ in range(n)]


def _stack(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def video_tower(model):
    """The model's video tower: VideoSwin's or CLIP's."""
    return model.video_encoder if model.is_videoswin else model.clip_vision


def expected_ln_launches(model, prompt: bool = False) -> int:
    """LayerNorm launches of one served or validated cap%tva batch: every
    LayerNorm of the two encoders and the adapters once, and every LayerNorm
    of the fusion encoder (embedding LN, self, cross and output LN of each
    layer) and of the head once per decode step, with one more a step where
    a prompt (a question) is embedded.  26 + 25 + 38 * 30 = 1191 for
    VALOR-base; 26 + 25 + 39 * 10 = 441 for qa%tva's 10 steps."""
    from valor_tpu_torch.ops.layers import LayerNorm

    def count(*mods):
        return sum(isinstance(x, LayerNorm) for m in mods if m is not None for x in m.modules())

    encode = count(video_tower(model), model.audio_encoder,
                   getattr(model, "video_adapter_ln", None), getattr(model, "audio_adapter_ln", None))
    step = count(model.multimodal_encoder, model.cls_head) + prompt
    return encode + step * model.cfg.max_generation_len


def phase_serving(model, cfg):
    import torch

    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig

    L, vocab = cfg.max_generation_len, cfg.fusion_vocab
    items = _items(cfg, 16)
    gen = Generator(model)
    refs = {}  # (item index, bucket, beam) -> reference row

    def reference(idx, bucket, beam):
        key = (idx, bucket, beam)
        if key not in refs:
            if bucket == 16 and beam == 1:
                rows = list(range(16))
            elif beam == 3 and bucket == 4:
                rows = [12, 13, 14, 15]
            else:
                rows = [idx] * bucket
            out = gen.generate(_stack([items[i] for i in rows]), ("tva",), max_len=L,
                               beam_size=beam)["generated_sequences_tva"].cpu().numpy()
            for pos, i in enumerate(rows):
                refs.setdefault((i, bucket, beam), out[pos])
        return refs[key]

    cfg_s = ServeConfig(buckets=(1, 4, 16), max_wait_ms=50.0, group="tva", max_len=L)
    torch.cuda.reset_peak_memory_stats()
    with InferenceEngine(model, cfg_s) as eng:
        t0 = time.monotonic()
        warm = [eng.submit(it) for it in items] + [eng.submit(it, beam_size=3) for it in items[12:]]
        for f in warm:
            f.result(timeout=600)
        log(f"serving warm-up (16 greedy + 4 beam-3): {time.monotonic() - t0:.2f} s")
        for i in range(16):
            reference(i, 16, 1)
        for i in range(12, 16):
            reference(i, 4, 3)
        eng.reset_stats()

        order = [j % 16 for j in range(48)]
        futs = [None] * 48

        def client(tid):
            for j in range(tid, 48, 8):
                futs[j] = eng.submit(items[order[j]])

        with record_ln_calls() as (sigs, _):
            K.LAUNCHES = 0  # the main path starts here
            t0 = time.monotonic()
            threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            greedy = [f.result(timeout=600) for f in futs]
            wall = time.monotonic() - t0
            stats = eng.stats()
            beam_futs = [eng.submit(items[i], beam_size=3) for i in range(12, 16)]
            beam = [f.result(timeout=600) for f in beam_futs]
            launches = K.LAUNCHES  # the main path ends here
        beam_stats = eng.stats()
    peak = torch.cuda.max_memory_allocated()

    per_batch = expected_ln_launches(model)
    batches = beam_stats["batches"]
    if launches != batches * per_batch:
        raise AssertionError(f"layernorm launches {launches} != {batches} batches x {per_batch}")
    checked = 0
    for j, r in enumerate(greedy):
        seq = r["sequences"]
        if seq.shape != (L,) or int(seq.max()) >= vocab or int(seq.min()) < 0:
            raise AssertionError(f"request {j}: bad sequence {seq}")
        if not np.array_equal(seq, reference(order[j], r["bucket"], 1)):
            raise AssertionError(f"request {j} (item {order[j]}, bucket {r['bucket']}) differs from direct generate")
        checked += 1
    for i, r in zip(range(12, 16), beam):
        if r["bucket"] != 4 or not np.array_equal(r["sequences"], reference(i, 4, 3)):
            raise AssertionError(f"beam request for item {i} differs from direct generate")
        checked += 1
    distinct = len({tuple(refs[(i, 16, 1)]) for i in range(16)})
    summary = {
        "captions_per_s": 48 / wall, "wall_s": wall, "batches": stats["batches"],
        "mean_occupancy": stats["mean_occupancy"],
        "latency_p50_s": stats["latency_p50_s"], "latency_p95_s": stats["latency_p95_s"],
        "batch_phase_mean_s": stats["batch_phase_mean_s"],
        "beam3_batch_latency_s": max(r["latency_s"] for r in beam),
        "max_memory_allocated_gib": peak / 2**30,
        "layernorm_launches": launches, "per_batch": per_batch, "batches_with_beam": batches,
        "rows_checked": checked, "distinct_captions_of_16": distinct,
        "layernorm_calls": sorted(sigs),
    }
    log("serving " + json.dumps(summary))
    return summary


# -- phase 5 ------------------------------------------------------------------
def phase_http(model, cfg):
    import urllib.error
    import urllib.request

    from PIL import Image

    from valor_tpu_torch.cli.serve import production_featurizer, start_server
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.validate import decode_sequence
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig

    words = ["a", "man", "is", "playing", "the", "guitar", "dog", "runs", "on", "grass"]
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]", "[unused99]", "[unused100]"] + words
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "vocab.txt").write_text("\n".join(vocab))
        tok = BertTokenizer(str(Path(tmp) / "vocab.txt"))
        rng = np.random.RandomState(1)
        paths = []
        for i in range(4):
            p = Path(tmp) / f"frame{i}.jpg"
            Image.fromarray(rng.randint(0, 256, (240, 320, 3), dtype=np.uint8)).save(p)
            paths.append(str(p))
        cfg_s = ServeConfig(buckets=(1, 4, 16), max_wait_ms=50.0, group="tva",
                            max_len=cfg.max_generation_len)
        with InferenceEngine(model, cfg_s) as eng:
            server = start_server(eng, production_featurizer(cfg, tok),
                                  lambda s: decode_sequence(tok, s), port=0)
            try:
                base = "http://%s:%d" % server.server_address

                def get(path):
                    with urllib.request.urlopen(base + path, timeout=60) as r:
                        return r.status, json.loads(r.read())

                def post(payload):
                    req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode())
                    try:
                        with urllib.request.urlopen(req, timeout=600) as r:
                            return r.status, json.loads(r.read())
                    except urllib.error.HTTPError as e:
                        return e.code, json.loads(e.read())

                if get("/healthz") != (200, {"ok": True}):
                    raise AssertionError("/healthz")
                with ThreadPoolExecutor(4) as pool:
                    outs = list(pool.map(lambda p: post({"image_path": p}), paths))
                for code, out in outs:
                    if code != 200 or not isinstance(out.get("text"), str):
                        raise AssertionError(f"POST /generate: {code} {out}")
                code, stats = get("/stats")
                if code != 200 or stats["requests"] != 4:
                    raise AssertionError(f"/stats: {code} {stats}")
                code, out = post({"image_path": str(Path(tmp) / "missing.jpg")})
                if code != 400:
                    raise AssertionError(f"missing image: expected 400, got {code} {out}")
                # questions: a short one, and one of 40 ids with [CLS] and [SEP] that no pad cuts
                asked = [post({"image_path": paths[0], "question": q})
                         for q in ("is the man playing", " ".join((words[:6] * 7)[:38]))]
                for qcode, qout in asked:
                    if qcode != 200 or not isinstance(qout.get("text"), str):
                        raise AssertionError(f"POST /generate with a question: {qcode} {qout}")
            finally:
                server.shutdown()
                server.server_close()
    log("http " + json.dumps({
        "generate": [{"bucket": o["bucket"], "batch_size": o["batch_size"],
                      "latency_s": o["latency_s"], "text": o["text"][:40]} for _, o in outs],
        "stats_batches": stats["batches"], "bad_request": code,
        "questions": [{"code": c, "bucket": o["bucket"], "text": o["text"][:40]} for c, o in asked],
    }))


# -- phase 6 ------------------------------------------------------------------
def check_bwd(x, w, eps, dy) -> tuple:
    """The backward kernel against its plain version; (max abs err of dx, dw,
    db).  dx within one ulp of its type relative plus 1e-5 of the largest |dx|
    (the row sums come in another order); dw and db within 1e-5 of the sum of
    the absolute terms they add (the reduction order over the rows)."""
    import torch

    from valor_tpu_torch.ops.kernels import layernorm as K

    dx, dw, db = K.layernorm_bwd(x, w, eps, dy)
    rx, rw, rb = K.layernorm_bwd_plain(x, w, eps, dy)
    torch.cuda.synchronize()
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -20
    ex = (dx.float() - rx.float()).abs()
    ok = bool((ex <= ulp * rx.float().abs() + 1e-5 * float(rx.float().abs().max())).all())
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    xhat = xc * torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    gabs = dy.float().abs()
    ew, eb = (dw - rw).abs(), (db - rb).abs()
    ok = ok and bool((ew <= 1e-5 * (gabs * xhat.abs()).sum(0)).all())
    ok = ok and bool((eb <= 1e-5 * gabs.sum(0)).all())
    errs = float(ex.max()), float(ew.max()), float(eb.max())
    if not ok:
        raise AssertionError(f"layernorm_bwd [{x.shape[0]}, {x.shape[1]}] x {x.dtype} dy {dy.dtype}, "
                             f"eps {eps}: dx, dw, db errors {errs}")
    return errs


def phase_layernorm_bwd():
    import torch

    from valor_tpu_torch.ops.kernels import layernorm as K

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, n, c, eps in LN_BWD_SHAPES:
        for xd, gd in MATCHED + (MIXED if name == "fusion_32x40" else []):
            x, w, _ = _ln_inputs(n, c, xd, gen)
            dy = torch.randn(n, c, device="cuda", generator=gen).to(getattr(torch, gd))
            ex, ew, eb = check_bwd(x, w, eps, dy)
            launches = K.LAUNCHES_BWD
            first, second = K.layernorm_bwd(x, w, eps, dy), K.layernorm_bwd(x, w, eps, dy)
            launches = (K.LAUNCHES_BWD - launches) // 2
            if not (torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])):
                raise AssertionError(f"layernorm_bwd [{n}, {c}] {xd} dy {gd}: dw or db differ "
                                     "between two calls on the same inputs")
            plan = K.bwd_plan(x, w, dy, first[0])
            if launches != 1 or plan["launches"] != 1:
                raise AssertionError(f"layernorm_bwd [{n}, {c}]: {launches} wrapper launches a "
                                     f"call, {plan['launches']} kernels a launch")
            del first, second
            wl, bl = w.to(x.dtype), torch.zeros(c, device="cuda", dtype=x.dtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], wl, bl, eps)
            dyl = dy.to(x.dtype)

            def aten_bwd():
                return torch.ops.aten.native_layer_norm_backward(
                    dyl, x, [c], mean, rstd, wl, bl, [True, True, True])

            row = {
                "shape": f"{name} [{n}, {c}] {xd}" + (f" dy {gd}" if gd != xd else ""),
                "sig": [n, c, eps, xd, gd], "max_abs_err": max(ex, ew, eb),
                "dx_err": ex, "dw_err": ew, "db_err": eb,
                "tol": "dx 1 ulp + 1e-5 max|dx|; dw, db 1e-5 sum|terms|",
                "kernel_ms": graph_ms(lambda: K.layernorm_bwd(x, w, eps, dy)),
                "plain_ms": graph_ms(lambda: K.layernorm_bwd_plain(x, w, eps, dy)),
                "library_ms": graph_ms(aten_bwd),
                "kernel_host_us": host_us(lambda: K.layernorm_bwd(x, w, eps, dy)),
                "library_host_us": host_us(aten_bwd),
                "deterministic": True, "one_launch": True, "partials": plan["partials"],
                "rows_per_group": plan["steps"], "wave": plan["wave"],
                "bound_ms": (n * c * (2 * x.element_size() + dy.element_size()) + 3 * c * 4)
                / HBM_BYTES_PER_S * 1e3,
            }
            rows.append(row)
            log("layernorm_bwd " + json.dumps(row))
            del x, dy, dyl, mean, rstd
    return rows


# -- phase 7 ------------------------------------------------------------------
def phase_train_card_vs_cpu(device: str = "cuda", task_name: str = PT_TASK, prompts: bool = False,
                            cfg_kw=None):
    """One training step of ``task_name`` on the tiny config (fp32,
    caption_type lm, dropout 0: no random draws; ``cfg_kw`` changes it, as
    phase a's MoE, GQA and VideoSwin variants) on the card and on the CPU
    from the same weights; a QA task takes a multi-answer batch with
    ``tile_index`` and ``answer_weights`` (``data/synthetic.py:qa_batch``);
    ``prompts`` adds the task prompts of ``use_task_prompt`` to the batch.
    With MoE layers the losses carry ``moe_aux`` as ``train_step`` adds it.
    Losses within 1e-4; gradients within 1e-4 absolute and relative (fp32
    sums in another order); updated parameters: every element within one
    learning-rate step and 99.9 % within 2 % of one (Adam turns a relative
    difference of a near-zero gradient into one of its step)."""
    import torch

    from valor_tpu_torch.core.config import TrainConfig
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import pretrain_batch, qa_batch
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.ops.layers import RNGStreams, rng_scope, sow_scope
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import moe_aux_weight_for, param_grads, with_moe_aux

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(tiny_config(), caption_type="lm", dropout=0.0, use_task_prompt=prompts,
                              **(cfg_kw or {}))
    lr = 1e-3
    tcfg = TrainConfig(learning_rate=lr, clip_lr=lr, clip_lr_text=lr, num_train_steps=10, grad_norm=0.5)
    sd = init_params(cfg, seed=0, device="cpu")
    task = parse_task(task_name)
    data = (qa_batch(cfg, 4, frames=2, clips=1, n_question=8, seed=1) if task.family == "qa"
            else pretrain_batch(cfg, 4, frames=2, clips=1, n_txt=8, seed=1))
    if prompts:
        data.update(tiny_prompts(task))
    res = {}
    for dev in ("cpu", device):
        model = train_model(cfg, {k: v.to(dev) for k, v in sd.items()}, dev)
        opt = build_optimizer(model, tcfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        fwd, bwd = K.LAUNCHES, K.LAUNCHES_BWD
        with rng_scope(RNGStreams(0)):
            with sow_scope() as sown:
                losses = model(batch, task)
            losses = with_moe_aux(losses, sown, moe_aux_weight_for(cfg))
            params = list(model.parameters())
            grads = param_grads(sum(losses.values()), params)
        opt.update(grads)
        res[dev] = ({k: float(v.detach()) for k, v in losses.items()}, [g.cpu() for g in grads],
                    [p.detach().cpu() for p in params], (K.LAUNCHES - fwd, K.LAUNCHES_BWD - bwd))
    torch.backends.cudnn.allow_tf32 = True
    (l_cpu, g_cpu, p_cpu, _), (l_gpu, g_gpu, p_gpu, launches) = res["cpu"], res[device]
    loss_err = max(abs(l_cpu[k] - l_gpu[k]) for k in l_cpu)
    if loss_err > 1e-4:
        raise AssertionError(f"card vs cpu training losses differ by {loss_err}: {l_gpu} vs {l_cpu}")
    names = [n for n, _ in train_model(cfg, sd, "cpu").named_parameters()]
    for name, a, b in zip(names, g_gpu, g_cpu):
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"card vs cpu gradient of {name}: max diff {float((a - b).abs().max())}")
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(p_gpu, p_cpu)])
    within = float((diff <= 2e-2 * lr).float().mean())
    if float(diff.max()) > lr or within < 0.999:
        raise AssertionError(f"card vs cpu updated parameters: max diff {float(diff.max())}, "
                             f"{within:.5f} within 2% of a step")
    if device == "cuda" and (launches[0] <= 0 or launches[0] != launches[1]):
        raise AssertionError(f"card training step launched {launches} layernorm kernels (fwd, bwd)")
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu))
    out = {"task": task_name, "cfg_kw": cfg_kw or {},
           "prompts": sorted(k for k in data if k.startswith("prompt_tokens")),
           "losses_cuda": l_gpu, "losses_cpu": l_cpu, "max_loss_diff": loss_err,
           "max_grad_diff": grad_err, "max_param_diff": float(diff.max()),
           "params_within_2pct_step": within, "layernorm_launches_fwd_bwd": launches}
    log("card vs cpu training step " + json.dumps(out))
    return out


# -- phase 8 ------------------------------------------------------------------
def expected_train_ln_launches(model, spec) -> int:
    """LayerNorms one training step runs (each once forward and once
    backward): the towers the task's groups use, the adapters (not in
    retrieval: its forward builds no fusion input), and the fusion encoder
    with its head once per caption, MLM or QA group.  26 ViT + 25 CLIP text +
    25 AST + 3 x 38 fusion = 190 for VALOR-base on
    pt_contra%tva%tv%ta_caption%tva%tv%ta; 26 + 25 + 25 = 76 on ret%tva%tv,
    also what one evaluation forward of ret%tva%tv runs; 26 + 25 + 38 = 89
    on cap%tva, and 90 on qa%tva, whose question prompt is embedded (and
    LayerNormed) apart from the answer.  With ``use_task_prompt`` each caption
    and MLM group embeds its prompt the same way (and a BERT text tower the
    contrastive one; the CLIP text tower has no embedding LayerNorm): 193 on
    VALOR-base's pretraining task."""
    from valor_tpu_torch.ops.layers import LayerNorm

    def count(mod, skip_cross=False):
        if mod is None:
            return 0
        return sum(isinstance(x, LayerNorm) and not (skip_cross and "cross_attn" in name)
                   for name, x in mod.named_modules())

    n, adapters = 0, spec.family in ("pt", "cap", "qa")
    if spec.uses_video:
        n += count(video_tower(model)) + adapters * count(getattr(model, "video_adapter_ln", None))
    if spec.uses_audio:
        n += count(model.audio_encoder) + adapters * count(getattr(model, "audio_adapter_ln", None))
    prompted = model.cfg.use_task_prompt and spec.family != "qa"
    if spec.contra_groups and any("t" in g for g in spec.contra_groups):
        n += count(model.text_encoder, skip_cross=True) + (prompted and not model.is_clip_text)
    fusion = count(model.multimodal_encoder) + count(model.cls_head) + (spec.family == "qa" or prompted)
    return n + fusion * (len(spec.caption_groups) + len(spec.mlm_groups))


def pipelined_encoders(model, spec) -> list:
    """(encoder, passes a step, text only) of every fusion-stack pass that a
    training step of ``spec`` runs pipelined: the fusion encoder once a
    caption or MLM group, and a BERT text tower with stages (the fusion
    encoder itself where shared), without media, for the contrastive groups
    that read text."""
    from valor_tpu_torch.models.bert import BertFusionEncoder

    out = [(model.multimodal_encoder, len(spec.caption_groups) + len(spec.mlm_groups), False)]
    txt = model.text_encoder
    if isinstance(txt, BertFusionEncoder) and spec.contra_groups and any("t" in g for g in spec.contra_groups):
        out.append((txt, 1, True))
    return [o for o in out if o[0].cfg.pipeline_stages > 0 and o[1]]


def expected_pipelined_ln_launches(model, spec, stage: int, stages: int, microbatches: int) -> int:
    """``expected_train_ln_launches`` of a pipe rank whose stacks run
    pipelined (``pipelined_encoders``): its stage's layers once a microbatch
    in place of every layer once (the embeddings and the head run on every
    rank, on its rows)."""
    from valor_tpu_torch.ops.layers import LayerNorm
    from valor_tpu_torch.parallel.pipeline import stage_layers

    n = expected_train_ln_launches(model, spec)
    for enc, passes, text_only in pipelined_encoders(model, spec):
        interleave = max(enc.cfg.pipeline_interleave, 1)
        mine = [i for chunk in stage_layers(len(enc.layers), stages, interleave)[stage] for i in chunk]
        per_layer = [sum(isinstance(x, LayerNorm) and not (text_only and "cross_attn" in name)
                         for name, x in layer.named_modules()) for layer in enc.layers]
        n += passes * (microbatches * sum(per_layer[i] for i in mine) - sum(per_layer))
    return n


def phase_pretrain(batch_size: int = 32, steps: int = 10, cfg=None, device: str = "cuda",
                   config: str = "pretrain-valor-base.json", task: str = PT_TASK, frames: int = 4,
                   n_txt: int = 40, label: str = "pretrain"):
    """``cfg`` None is ``configs/<config>``'s model (VALOR-base pretraining by
    default; phase e runs ``caption-mscoco.json`` at 392 px on ``cap%tv`` with
    one frame); a CPU rehearsal passes a tiny config and device "cpu"."""
    import torch

    from valor_tpu_torch.core.config import Config, load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import pretrain_batch
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState
    from valor_tpu_torch.train.trainer import Trainer

    full = load_config(str(ROOT / "configs" / config))
    cfg = cfg or full.model
    # the schedule spans this run: warm-up to the config's peak rate in the first step
    tcfg = dataclasses.replace(full.train, num_train_steps=steps + 1)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.monotonic()
    model = train_model(cfg, init_params(cfg, seed=0, device=device), device)
    state = TrainState(model, build_optimizer(model, tcfg, cfg.frozen_vision, cfg.frozen_multimodal))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{config} model ({cfg.dtype}, {n_params / 1e6:.1f} M params, "
        f"remat {cfg.checkpointing}) built in {time.monotonic() - t0:.1f} s")
    data = pretrain_batch(cfg, batch_size, frames=frames, clips=1, n_txt=n_txt, seed=0)
    spec = parse_task(task)
    per_step = expected_train_ln_launches(model, spec)
    stamps = []

    def hook(micro, task_name, metrics):
        sync()
        stamps.append(time.perf_counter())

    trainer = Trainer(Config(model=cfg, train=tcfg), state, [(task, data)] * (steps + 1),
                      step_hook=hook)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with record_ln_calls() as (sigs_fwd, sigs_bwd):
        K.LAUNCHES = K.LAUNCHES_BWD = 0  # the main path starts here
        t_start = time.perf_counter()
        trainer.run()
        launches = (K.LAUNCHES, K.LAUNCHES_BWD)  # the main path ends here
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    step_s = np.diff([t_start] + stamps)
    totals = [h[2]["total_loss"] for h in trainer.history]
    if len(totals) != steps + 1 or state.optimizer.gradient_step != steps + 1:
        raise AssertionError(f"{len(totals)} steps logged, {state.optimizer.gradient_step} updates")
    if not all(np.isfinite(v) for h in trainer.history for v in h[2].values()):
        raise AssertionError(f"non-finite loss: {trainer.history}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"total loss did not fall on the repeated batch: {totals}")
    expected = per_step * (steps + 1) if cuda else 0
    if launches != (expected, expected):
        raise AssertionError(f"layernorm launches (fwd, bwd) {launches} != {steps + 1} steps x {per_step}")
    median = float(np.median(step_s[1:]))
    summary = {
        "config": f"configs/{config}", "task": task, "frames": frames, "video_resolution": cfg.video_resolution,
        "batch": batch_size, "timed_steps": steps, "median_step_s": median,
        "samples_per_s": batch_size / median, "warmup_step_s": float(step_s[0]),
        "step_s": [float(v) for v in step_s],
        "max_memory_allocated_gib": peak / 2**30, "params_m": n_params / 1e6,
        "total_loss": totals, **{k: [h[2][k] for h in trainer.history] for k in trainer.history[0][2]},
        "layernorm_launches_fwd_bwd": launches, "per_step": per_step,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
    }
    log(f"{label} " + json.dumps(summary))
    return summary


# -- phase 10 -----------------------------------------------------------------
def _fs_inputs(a, b, t, v, d, dtype, gen, edge=None) -> list:
    """Fine-score inputs on the generator's device: unit-norm token features (as
    the eval path's are), query masks with a valid first token, all-ones
    gallery masks, N(0, 1) raw weights; ``edge`` as in tests/test_pallas.py."""
    import torch
    import torch.nn.functional as F

    dev = gen.device
    fa = F.normalize(torch.randn(a, t, d, device=dev, generator=gen), dim=-1)
    fb = F.normalize(torch.randn(b, v, d, device=dev, generator=gen), dim=-1)
    ma = (torch.rand(a, t, device=dev, generator=gen) > 0.3).float()
    ma[:, 0] = 1.0
    mb = torch.ones(b, v, device=dev)
    if edge == "negative_rows":  # every dot negative: padding may not inject a 0
        fa, fb, ma = fa.abs(), -fb.abs(), torch.ones_like(ma)
    elif edge == "masked_tokens_zero":  # a masked token adds a literal 0 to the maxes
        fa, fb = -fa.abs(), fb.abs()
        ma[:, 1] = 0.0
    wa = torch.randn(a, t, device=dev, generator=gen)
    wb = torch.randn(b, v, device=dev, generator=gen)
    return [fa.to(dtype), fb.to(dtype), ma, mb, wa, wb]


def check_fine(args, what: str) -> float:
    """The fine-score kernel against its plain version on ``args``; the max abs err."""
    import torch

    from valor_tpu_torch.ops.kernels import fine_score as K2

    got = K2.fine_score_fused(*args)
    ref = K2.fine_score_fused_plain(*args)
    torch.cuda.synchronize()
    return check_scores(got, ref, what)


def fine_bounds(a, b, t, v, d, feat_dtype) -> dict:
    """The least time of the fine score on the card: 2*A*B*T*V*D flops at the
    card's peak for the feature type, against the bytes of every input read
    once (features, masks, raw weights) and the output written once.  bf16
    products are exact in fp32, so bf16 runs at the tensor cores' bf16 rate.
    fp32 has two ways: the FMA units, and 3xTF32 (three TF32 products, which
    hold the tolerance, ``FS_TOL``); its operations bound is the faster of the
    two, and ``ops_peak`` names it."""
    import torch

    flop = 2 * a * b * t * v * d
    if feat_dtype == torch.bfloat16:
        ways = {"bf16 tensor cores": flop / BF16_FLOPS_PER_S * 1e3}
    else:
        ways = {"fp32 FMA": flop / FP32_FLOPS_PER_S * 1e3, "3xTF32 tensor cores": 3 * flop / TF32_FLOPS_PER_S * 1e3}
    ops_peak = min(ways, key=ways.get)
    nbytes = (a * t + b * v) * (d * feat_dtype.itemsize + 8) + a * b * 4
    ops_ms, bytes_ms = ways[ops_peak], nbytes / HBM_BYTES_PER_S * 1e3
    return {"flop": flop, "bytes": nbytes, "ops_bound_ms": ops_ms, "ops_peak": ops_peak,
            "ops_bound_ms_by_peak": ways, "bytes_bound_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_fine_score():
    import torch

    from valor_tpu_torch.ops.kernels import fine_score as K2

    torch.backends.cuda.matmul.allow_tf32 = False  # the GEMM yardstick in full fp32
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for name, a, b, t, v, d in FS_SHAPES:
        big = a * b * t * v * d > 1e12  # the MSCOCO gallery: about 0.1 s a call
        iters, reps = (2, 2) if big else (5, 3)
        for dt in ("float32", "bfloat16") if name == "msrvtt_tva" else ("float32",):
            args = _fs_inputs(a, b, t, v, d, getattr(torch, dt), gen)
            err = check_fine(args, f"fine_score {name} {dt}")
            qa, gb = args[0].float().reshape(a * t, d), args[1].float().reshape(b * v, d)
            prod = torch.empty(a * t, b * v, device="cuda")
            row = {
                "shape": f"{name} A={a} B={b} T={t} V={v} D={d} {dt}", "sig": [a, b, t, v, d, dt],
                "max_abs_err": err, "tol": FS_TOL,
                "kernel_ms": graph_ms(lambda: K2.fine_score_fused(*args), iters, reps),
                "plain_ms": graph_ms(lambda: K2.fine_score_fused_plain(*args), iters, reps),
                "gemm_ms": graph_ms(lambda: torch.matmul(qa, gb.t(), out=prod), iters, reps),
                "kernel_host_us": host_us(lambda: K2.fine_score_fused(*args), 5 if big else 20),
                **fine_bounds(a, b, t, v, d, args[0].dtype),
            }
            if dt == "bfloat16":  # the bare bf16 product beside the fp32 one (yardsticks)
                del prod
                qh, gh = args[0].reshape(a * t, d), args[1].reshape(b * v, d)
                prod = torch.empty(a * t, b * v, device="cuda", dtype=torch.bfloat16)
                row["gemm_bf16_ms"] = graph_ms(lambda: torch.matmul(qh, gh.t(), out=prod), iters, reps)
            else:  # one TF32 product: what cuBLAS reaches in TF32 (3xTF32 does three)
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    row["gemm_tf32_ms"] = graph_ms(lambda: torch.matmul(qa, gb.t(), out=prod), iters, reps)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
            row["tflop_per_s"] = row["flop"] / row["kernel_ms"] / 1e9
            # the bytes that the product's tiles copy from the packed operands, and their rate:
            # the operand traffic that a tile's size sets
            row["tile_read_bytes"] = K2.layout(a, b, t, v, d, dt == "bfloat16")["read_bytes"]
            row["tile_read_tb_per_s"] = row["tile_read_bytes"] / row["kernel_ms"] / 1e9
            rows.append(row)
            log("fine_score " + json.dumps(row))
            del args, qa, gb, prod
            gc.collect()
            torch.cuda.empty_cache()
    for name, a, b, t, v, d, dt in FS_EDGES:
        args = _fs_inputs(a, b, t, v, d, getattr(torch, dt), gen, edge=name)
        err = check_fine(args, f"fine_score edge case {name} D={d} {dt}")
        if name == "negative_rows" and not float(K2.fine_score_fused(*args).max()) < 0:
            raise AssertionError("negative_rows: the edge case is not live (a score is >= 0)")
        row = {"shape": f"{name} A={a} B={b} T={t} V={v} D={d} {dt}",
               "sig": [a, b, t, v, d, dt], "max_abs_err": err, "tol": FS_TOL}
        rows.append(row)
        log("fine_score " + json.dumps(row))
    return rows


# -- phase 11 -----------------------------------------------------------------
def phase_ret_card_vs_cpu(device: str = "cuda"):
    """The tiny config's ``ret%tva%tv`` training step (phase 7's comparison) and
    its ``validate_ret`` over a 12-item gallery, on the card and on the CPU
    from the same weights, fp32 with TF32 off: score matrices within
    ``FS_TOL``, reports equal, and K2 launched once a fine group on the card."""
    import torch

    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import retrieval_batch
    from valor_tpu_torch.eval.validate import validate_ret
    from valor_tpu_torch.models.bridge import init_params, load_model
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.train.step import eval_step

    train = phase_train_card_vs_cpu(device, RET_TASK)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_config()
    sd = init_params(cfg, seed=0, device="cpu")
    gallery = [retrieval_batch(cfg, 4, frames=2, clips=1, n_txt=8, seed=40 + i, id_offset=4 * i)
               for i in range(3)]
    spec = parse_task(RET_TASK)
    res = {}
    for dev in ("cpu", device):
        model = load_model(cfg, {k: v.to(dev) for k, v in sd.items()}, dev)
        k2 = K2.LAUNCHES
        with record_scores() as calls:
            report = validate_ret(model, eval_step, gallery, spec, cfg.contra_type)
        res[dev] = (report, {g: s.cpu() for g, _, s, _ in calls}, K2.LAUNCHES - k2)
    torch.backends.cudnn.allow_tf32 = True
    (rep_cpu, s_cpu, _), (rep_dev, s_dev, k2) = res["cpu"], res[device]
    errs = {g: check_scores(s_dev[g], s_cpu[g], f"tiny validate_ret {g}: card vs cpu") for g in s_cpu}
    if rep_dev != rep_cpu:
        raise AssertionError(f"tiny validate_ret reports differ: card {rep_dev} cpu {rep_cpu}")
    if device == "cuda" and k2 != len(spec.contra_groups):
        raise AssertionError(f"tiny validate_ret launched K2 {k2} times for {spec.contra_groups}")
    out = {"train_step": train, "score_max_abs_err": errs, "report": rep_dev, "fine_score_launches": k2}
    log("card vs cpu retrieval " + json.dumps(out))
    return out


# -- phase 12 -----------------------------------------------------------------
def phase_retrieval(batch_size: int = 64, steps: int = 10, items: int = 1000, eval_batch: int = 64,
                    cfg=None, device: str = "cuda"):
    """``cfg`` None is VALOR-base; a CPU rehearsal passes a tiny config, small
    sizes and device "cpu"."""
    import torch
    import torch.nn.functional as F

    from valor_tpu_torch.core.config import Config, load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import retrieval_batch
    from valor_tpu_torch.eval.retrieval import retrieval_report
    from valor_tpu_torch.eval.validate import retrieval_scores, validate_ret
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, eval_step
    from valor_tpu_torch.train.trainer import Trainer

    full = load_config(str(ROOT / "configs" / "retrieval-msrvtt.json"))
    cfg = cfg or full.model
    # the schedule spans this run; the only evaluation is the trainer's final one
    tcfg = dataclasses.replace(full.train, num_train_steps=steps + 1, valid_steps=0)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.monotonic()
    model = train_model(cfg, init_params(cfg, seed=0, device=device), device)
    state = TrainState(model, build_optimizer(model, tcfg, cfg.frozen_vision, cfg.frozen_multimodal))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"VALOR-base retrieval model ({cfg.dtype}, {n_params / 1e6:.1f} M params, contra "
        f"{cfg.contra_type}) built in {time.monotonic() - t0:.1f} s")
    spec = parse_task(RET_TASK)
    t0 = time.monotonic()
    data = retrieval_batch(cfg, batch_size, frames=4, clips=2, n_txt=32, seed=0)  # the train flow's
    gallery = [retrieval_batch(cfg, min(eval_batch, items - i), frames=8, clips=2, n_txt=32,
                               seed=1000 + i, id_offset=i) for i in range(0, items, eval_batch)]
    ids = [i for b in gallery for i in b["ids"]]
    gallery_s = time.monotonic() - t0
    stamps, evals, peaks = [], [], []

    def hook(micro, task_name, metrics):
        sync()
        stamps.append(time.perf_counter())
        peaks.append(torch.cuda.max_memory_allocated() if cuda else 0)

    def validate(m, step):
        sync()
        start = time.perf_counter()
        with record_scores() as calls:
            report = validate_ret(m, eval_step, gallery, spec, cfg.contra_type)
        sync()
        evals.append({"report": report, "calls": calls, "start": start, "end": time.perf_counter()})
        return {"msrvtt_ret": report}

    trainer = Trainer(Config(model=cfg, train=tcfg), state, [(RET_TASK, data)] * (steps + 1),
                      validate_fn=validate, step_hook=hook)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with record_ln_calls() as (sigs_fwd, sigs_bwd), record_fine_calls() as fine_calls:
        K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
        t_start = time.perf_counter()
        trainer.run()
        launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here

    step_s = np.diff([t_start] + stamps)
    contra = [h[2]["contra_loss"] for h in trainer.history]
    if len(contra) != steps + 1 or state.optimizer.gradient_step != steps + 1:
        raise AssertionError(f"{len(contra)} steps logged, {state.optimizer.gradient_step} updates")
    if not all(np.isfinite(v) for h in trainer.history for v in h[2].values()):
        raise AssertionError(f"non-finite loss: {trainer.history}")
    if not contra[-1] < contra[0]:
        raise AssertionError(f"contrastive loss did not fall on the repeated batch: {contra}")
    if len(evals) != 1:
        raise AssertionError(f"{len(evals)} evaluations, expected the final one")
    ev, fine_groups = evals[0], spec.contra_groups if cfg.contra_type == "fine" else ()
    report = ev["report"]
    keys = [f"{g}_forward_{k}" for g in spec.contra_groups
            for k in ("r1", "r5", "r10", "ravg", "medianR", "meanR")] + ["ravg"]
    if not all(k in report and np.isfinite(report[k]) for k in keys):
        raise AssertionError(f"report lacks a key or has a non-finite value: {report}")
    expected_k2 = sum(2 if g == "tva" and cfg.late_fusion else 1 for g in fine_groups) if cuda else 0
    per_step = expected_train_ln_launches(model, spec)
    expected_ln = ((per_step * (steps + 1 + len(gallery)), per_step * (steps + 1)) if cuda else (0, 0))
    if launches != expected_ln + (expected_k2,):
        raise AssertionError(f"launches (ln fwd, ln bwd, fine_score) {launches} != "
                             f"{expected_ln + (expected_k2,)}")
    # the same features through the plain chunked path on the same device
    temp = float(model.temperature().detach())
    score_err = {}
    for g, feats, score, _ in ev["calls"]:
        plain = chunked_scores(model, feats, g, cfg.contra_type)
        score_err[g] = check_scores(score, plain, f"retrieval {g}: kernel vs chunked")
        want = {f"{g}_{k}": v for k, v in retrieval_report(plain.cpu().numpy(), ids, ids, False, temp).items()}
        if {k: report[k] for k in want} != want:
            raise AssertionError(f"retrieval {g}: report from the kernel's scores {report} != "
                                 f"report from the chunked scores {want}")
    # va self-retrieval through the kernel: identical unit-norm audio and video
    # tokens put each item's self-score (1) above every other
    gen = torch.Generator(device=device).manual_seed(5)
    x = F.normalize(torch.randn(items, 8, model.contra_dim, device=device, generator=gen), dim=-1)
    k2 = K2.LAUNCHES
    self_rep = retrieval_report(retrieval_scores(
        model, {"feat_t": None, "feat_v": x, "feat_a": x.clone(), "txt_tokens": None},
        "va", "fine").cpu().numpy(), ids, ids)
    if self_rep["forward_r1"] != 100.0 or K2.LAUNCHES - k2 != int(cuda):
        raise AssertionError(f"va self-retrieval: {self_rep}, {K2.LAUNCHES - k2} launches")

    median = float(np.median(step_s[1:]))
    extract_s = ev["calls"][0][3] - ev["start"]
    summary = {
        "batch": batch_size, "timed_steps": steps, "median_step_s": median,
        "samples_per_s": batch_size / median, "warmup_step_s": float(step_s[0]),
        "step_s": [float(v) for v in step_s], "train_max_memory_allocated_gib": peaks[-1] / 2**30,
        "params_m": n_params / 1e6, "contra_loss": contra,
        "grad_norm": [h[2]["grad_norm"] for h in trainer.history],
        "gallery_items": items, "gallery_batches": len(gallery), "gallery_made_s": gallery_s,
        "eval_s": ev["end"] - ev["start"], "extract_s": extract_s, "items_per_s": items / extract_s,
        "fine_score_ms_by_call": [ms for _, ms in fine_calls], "score_max_abs_err": score_err,
        "report": report, "va_self_forward_r1": self_rep["forward_r1"],
        "layernorm_launches_fwd_bwd": launches[:2], "fine_score_launches": launches[2],
        "ln_per_forward": per_step,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
        "fine_score_calls": sorted({tuple(s) for s, _ in fine_calls}),
    }
    log("retrieval " + json.dumps(summary))
    return summary


# -- phase 13 -----------------------------------------------------------------
def phase_resume_tiny(device: str = "cuda"):
    """Exact resume on the card: the tiny config trains ``pt_contra%tv_caption%tv``
    (dropout and token masks on) for 6 updates of 2 micro-batches in one run, and
    in a second run that stops after micro-batch 5, saves, restores into a fresh
    model and optimizer, and goes on.  Under ``torch.use_deterministic_algorithms``
    (warn_only, so that every op without a deterministic version is named) the
    two end with the same bits in every parameter and optimizer tensor; where an
    op is named, the bits are reported and not required."""
    import os
    import warnings

    import torch

    from valor_tpu_torch.core.config import Config, TrainConfig
    from valor_tpu_torch.data.synthetic import pretrain_batch
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.train import checkpoints as C
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState
    from valor_tpu_torch.train.trainer import Trainer

    task, steps, accum, kill = "pt_contra%tv_caption%tv", 6, 2, 5
    cfg = tiny_config()
    tcfg = TrainConfig(num_train_steps=steps, gradient_accumulation_steps=accum, learning_rate=1e-3,
                       clip_lr=1e-3, clip_lr_text=1e-3, valid_steps=0, seed=0)
    sd = init_params(cfg, seed=0, device="cpu")
    batches = [(task, pretrain_batch(cfg, 4, frames=1, clips=1, n_txt=8, seed=100 + i))
               for i in range(steps * accum)]

    def build():
        model = train_model(cfg, {k: v.to(device) for k, v in sd.items()}, device)
        return TrainState(model, build_optimizer(model, tcfg))

    def tensors(state):
        opt = state.optimizer.state_dict()
        return ([v.cpu() for v in state.model.state_dict().values()]
                + [t.cpu() for t in opt["mu"] + opt["nu"] + (opt["acc"] or [])],
                (state.step, opt["count"], opt["mini_step"], opt["gradient_step"]))

    prev_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, tempfile.TemporaryDirectory() as tmp:
            warnings.simplefilter("always")
            run = Config(model=cfg, train=tcfg)
            a = Trainer(run, build(), list(batches)).run()
            saver = C.ModelSaver(tmp)
            killed = Trainer(run, build(), list(batches[:kill]), saver=saver).run()
            fresh = build()
            C.load_state(fresh, saver.restore())
            restored_equal = tensors(fresh)[1] == tensors(killed)[1] and all(
                torch.equal(x, y) for x, y in zip(tensors(fresh)[0], tensors(killed)[0]))
            b = Trainer(run, fresh, list(batches[kill:])).run()
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_cfg is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_cfg
    (ta, ca), (tb, cb) = tensors(a), tensors(b)
    differing = sum(not torch.equal(x, y) for x, y in zip(ta, tb))
    ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                  for w in caught if "deterministic" in str(w.message)})
    if not restored_equal:
        raise AssertionError("tiny resume: the restored state differs from the saved one")
    if ca != cb or (not ops and differing):
        raise AssertionError(f"tiny resume: {differing} of {len(ta)} tensors differ, counters {ca} vs {cb}, "
                             f"with no op lacking a deterministic version")
    out = {"device": device, "micro_steps": steps * accum, "stopped_after": kill,
           "restored_state_bit_equal": restored_equal, "counters": list(ca),
           "tensors": len(ta), "tensors_differing": differing, "bit_identical": differing == 0,
           "ops_without_deterministic_version": ops}
    log("tiny exact resume " + json.dumps(out))
    return out


# -- phase 14 -----------------------------------------------------------------
@contextlib.contextmanager
def record_trainers(sync, cuda: bool):
    """Yields a list that fills with one record a ``Trainer`` built inside the
    block: the trainer, host stamps after a synchronisation at every step, the
    run's data wait at each stamp, and the peak device memory since the trainer
    was built (after any evaluation before training).  It swaps the class where
    ``cli/train.py`` looks it up, and launches nothing itself."""
    import torch

    from valor_tpu_torch.train import trainer as T

    runs, base = [], T.Trainer

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec = {"trainer": self, "stamps": [], "waits": [], "peak": 0}
            runs.append(rec)

            def hook(micro, task_name, metrics):
                sync()
                rec["stamps"].append(time.perf_counter())
                rec["waits"].append(self.data_wait_s)

            self.step_hook = hook

        def run(self):
            rec = runs[-1]
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sync()
            rec["start"] = time.perf_counter()
            try:
                return super().run()
            finally:
                rec["peak"] = torch.cuda.max_memory_allocated() if cuda else 0

    T.Trainer = Recorded
    try:
        yield runs
    finally:
        T.Trainer = base


@contextlib.contextmanager
def record_validations(sync):
    """Yields a list that fills with (items, seconds between two
    synchronisations, report) of every ``validate_ret`` call."""
    from valor_tpu_torch.eval import validate as V

    calls, fn0 = [], V.validate_ret

    def fn1(model, step_fn, loader, *a, **kw):
        items = [0]

        def counted(it):
            for b in it:
                items[0] += len(b["ids"])
                yield b

        sync()
        t0 = time.perf_counter()
        report = fn0(model, step_fn, counted(loader), *a, **kw)
        sync()
        calls.append((items[0], time.perf_counter() - t0, report))
        return report

    V.validate_ret = fn1
    try:
        yield calls
    finally:
        V.validate_ret = fn0


@contextlib.contextmanager
def record_checkpoints(sync, on_restore):
    """Yields a dict that fills with the seconds every save blocked its caller
    (all of the write when synchronous, the snapshot when asynchronous), the
    seconds every ``finish`` waited for a write in flight, the seconds of
    every restore (read from disk and copied into the model and the
    optimizer), and the savers themselves (their ``writes``: step, host time
    the write began and was durable); ``on_restore(state)`` runs on each
    restored state."""
    from valor_tpu_torch.train import checkpoints as C

    times = {"save_s": [], "finish_s": [], "restore_s": [], "savers": []}
    save0, finish0, restore0, load0 = C.ModelSaver.save, C.ModelSaver.finish, C.ModelSaver.restore, C.load_state
    pending = {}

    def save1(self, state, step, best_name=None):
        if self not in times["savers"]:
            times["savers"].append(self)
        sync()
        t0 = time.perf_counter()
        save0(self, state, step, best_name)
        times["save_s"].append(time.perf_counter() - t0)

    def finish1(self):
        waiting = self._pending is not None
        t0 = time.perf_counter()
        finish0(self)
        if waiting:
            times["finish_s"].append(time.perf_counter() - t0)

    def restore1(self, step=None):
        sync()
        pending["t0"] = time.perf_counter()
        return restore0(self, step)

    def load1(state, payload):
        load0(state, payload)
        sync()
        times["restore_s"].append(time.perf_counter() - pending.pop("t0"))
        on_restore(state)

    C.ModelSaver.save, C.ModelSaver.finish, C.ModelSaver.restore, C.load_state = save1, finish1, restore1, load1
    try:
        yield times
    finally:
        C.ModelSaver.save, C.ModelSaver.finish, C.ModelSaver.restore, C.load_state = save0, finish0, restore0, load0


def check_async_snapshot(state, out_dir: str) -> dict:
    """An asynchronous save's snapshot against the update queued right after
    it, on the card.  ``ModelSaver(use_async=True)`` saves ``state`` once (its
    host buffers allocated), then again with its write held back, and
    ``state``'s optimizer at once updates every live parameter and both
    moments (no synchronisation between; the learning rate held at 1e-2,
    since a run's schedule ends at 0), then the write goes on.  The
    payload handed to ``torch.save`` (the bytes the checkpoint holds) must
    equal, bit for bit, the state cloned on the card before the saves, and the
    update must have changed every live parameter.  The second save returns
    in milliseconds while its copies take tenths of a second, so a snapshot
    the update can overtake (no wait on the copy's event) hands over updated
    values."""
    import torch

    from valor_tpu_torch.train import checkpoints as TC

    opt = state.optimizer
    grads = [torch.randn_like(p) for p in opt.params]  # made before the saves, so the update queues at once
    want = {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "mu": [m.clone() for m in opt.mu], "nu": [v.clone() for v in opt.nu]}
    gate, handed, save0 = threading.Event(), [], TC.torch.save

    def held_save(obj, f, *a, **kw):  # a write: held while the gate is shut; its payload kept in place of the file
        if not gate.wait(600):
            raise TimeoutError("the held checkpoint write was never released")
        handed.append(obj)

    TC.torch.save = held_save
    schedules, opt.schedules = opt.schedules, {k: (lambda step: 1e-2) for k in opt.schedules}  # a run's end: 0
    try:
        saver = TC.ModelSaver(out_dir, use_async=True)
        gate.set()
        saver.save(state, opt.gradient_step)
        saver.finish()
        gate.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(state, opt.gradient_step + 1)
        blocked = time.perf_counter() - t0
        opt.update(grads)
        torch.cuda.synchronize()
        live = [n for n, lbl in zip(opt.names, opt.labels) if lbl != "frozen"]
        params = dict(state.model.named_parameters())
        unmoved = [n for n in live if torch.equal(params[n], want["params"][n])]
        gate.set()
        saver.finish()
    finally:
        gate.set()
        TC.torch.save, opt.schedules = save0, schedules
    if len(handed) != 2 or unmoved:
        raise AssertionError(f"async snapshot check: {len(handed)} writes; parameters the update left: {unmoved[:5]}")
    got = handed[-1]
    bad = [k for k, v in want["params"].items() if not torch.equal(got["params"][k].to(v.device), v)]
    for key in ("mu", "nu"):
        bad += [f"{key} {i}" for i, (h, w) in enumerate(zip(got["opt_state"][key], want[key]))
                if not torch.equal(h.to(w.device), w)]
    if bad:
        raise AssertionError(f"async snapshot check: the checkpoint holds the update's values for {bad[:10]} "
                             f"({len(bad)} tensors)")
    return {"tensors": len(want["params"]) + 2 * len(want["mu"]), "save_blocked_s": blocked,
            "bytes": sum(t.numel() * t.element_size() for t in TC._tensors(got))}


def snapshot_state(state) -> dict:
    """A CPU copy of what a checkpoint holds: parameters, optimizer tensors and counters."""
    opt = state.optimizer.state_dict()
    return {"params": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "tensors": [t.cpu().clone() for t in opt["mu"] + opt["nu"] + (opt["acc"] or [])],
            "counters": (state.step, opt["count"], opt["mini_step"], opt["gradient_step"]),
            "acc": opt["acc"] is not None}


def check_same_state(state, saved: dict) -> dict:
    """``state`` equal to ``saved`` (``snapshot_state``) bit for bit, or raise."""
    now = snapshot_state(state)
    if now["counters"] != saved["counters"] or now["acc"] != saved["acc"]:
        raise AssertionError(f"restored counters {now['counters']} != saved {saved['counters']}")
    bad = [k for k, v in saved["params"].items() if not torch_equal(now["params"][k], v)]
    bad += [f"optimizer tensor {i}" for i, (x, y) in enumerate(zip(now["tensors"], saved["tensors"]))
            if not torch_equal(x, y)]
    if bad or len(now["tensors"]) != len(saved["tensors"]):
        raise AssertionError(f"restored state differs from the saved one: {bad[:10]}")
    return {"params": len(saved["params"]), "optimizer_tensors": len(saved["tensors"]),
            "counters_step_count_mini_gradient": list(saved["counters"]), "acc": saved["acc"]}


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def check_device_fbank(batch, cfg, device: str) -> dict:
    """The device fbank of a collated batch's clip spans against ``fbank_np`` of
    the same spans (masked and normalised as the host path), 1e-4 absolute and
    relative, with TF32 switched on around the call (the function must not
    depend on it); and its device time a batch."""
    import torch

    from valor_tpu_torch.data.fbank import fbank_clips_from_spans, fbank_np

    wavs, valid = batch["audio_waveforms"], batch["audio_valid_frames"]
    kw = dict(melbins=cfg.audio_melbins, target_length=cfg.audio_target_length)
    w, v = torch.as_tensor(wavs).to(device), torch.as_tensor(valid).to(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = fbank_clips_from_spans(w, v, **kw).cpu().numpy()
        ms = graph_ms(lambda: fbank_clips_from_spans(w, v, **kw), iters=5, reps=3) \
            if device == "cuda" else None
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    t, mean, std = cfg.audio_target_length, cfg.audio_mean, cfg.audio_std
    err = 0.0
    for b in range(wavs.shape[0]):
        for c in range(wavs.shape[1]):
            n = int(valid[b, c])
            ref = fbank_np(np.asarray(wavs[b, c]), 22050, cfg.audio_melbins)
            ref = np.where(np.arange(t)[:, None] < max(n, 0), ref, 0.0)
            ref = ((ref - mean) / (2 * std) * (n >= 0)).T
            diff = np.abs(out[b, c] - ref)
            if not (diff <= 1e-4 + 1e-4 * np.abs(ref)).all():
                raise AssertionError(f"device fbank of span ({b}, {c}): max abs err {diff.max()}")
            if n < 0 and out[b, c].any():
                raise AssertionError(f"device fbank of missing audio ({b}, {c}) is not exactly zero")
            err = max(err, float(diff.max()))
    return {"spans": int(np.prod(wavs.shape[:2])), "missing": int((valid < 0).sum()),
            "max_abs_err": err, "tol": "abs 1e-4 + rel 1e-4", "device_ms_a_batch": ms}


def point_at(raw: dict, paths: dict) -> None:
    """Every flow of the config ``raw`` at the split files, frames and audio of
    ``paths`` (a ``data/synthetic.py`` writer's)."""
    for split in ("train", "val"):
        for flow in raw["data_cfg"][split]:
            for ds in flow["datasets"]:
                ds.update(ids_path=paths[f"{split}_ids"], txt=paths[f"{split}_txt"],
                          video=paths["frames"], audio=paths["audio"])


@contextlib.contextmanager
def cli_run(paths: dict, tmp: str, name: str, edit):
    """A config from ``configs/<name>`` with ``edit(raw)`` applied, written
    under ``tmp``, and the tokenizer and weight paths of ``paths`` in the
    environment inside the block; yields the config's path."""
    import os

    raw = json.loads((ROOT / "configs" / name).read_text())
    edit(raw)
    cfg_path = os.path.join(tmp, f"config_{name}")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    env0 = {k: os.environ.get(k) for k in ("VALOR_BERT_VOCAB", "VALOR_CLIP_BPE", "VALOR_PRETRAINED_DIR")}
    os.environ.update(VALOR_BERT_VOCAB=paths["vocab"], VALOR_CLIP_BPE=paths["merges"],
                      VALOR_PRETRAINED_DIR=os.path.join(tmp, "no_public_weights"))
    try:
        yield cfg_path
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_cli_train(steps: int = 10, n_train: int = 320, n_val: int = 128, fixture=None, overrides=None,
                    device: str = "cuda", synthetic=None, root=None):
    """``valor_tpu_torch.cli.train`` from disk at the full width of
    ``configs/retrieval-msrvtt.json`` (only the dataset paths, ``output_dir``,
    ``num_train_steps`` and ``valid_steps`` changed): a seeded MSR-VTT-shaped
    dataset written to a temporary directory (``data/synthetic.py``), run 1 of
    ``steps`` steps, run 2 resumed to twice that.  ``fixture`` and ``overrides``
    shrink the dataset and the model for a CPU rehearsal (device "cpu");
    ``synthetic`` is phase 12's summary, whose samples/s this run's is set against.
    With ``root`` the dataset stays there for phase 18 (its paths under
    "paths" in the summary) and the runs' checkpoints are deleted."""
    import os
    import shutil

    import torch

    from valor_tpu_torch.cli.build import build_dataset, build_tokenizers
    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.pipeline import valor_collate
    from valor_tpu_torch.data.synthetic import write_retrieval_dataset
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dev_args = [] if cuda else ["--device", device]
    saved, restored = {}, {}
    with (contextlib.nullcontext(root) if root else tempfile.TemporaryDirectory(prefix="valor_cli_train_")) \
            as tmp:
        t0 = time.monotonic()
        paths = write_retrieval_dataset(os.path.join(tmp, "data"), n_train=n_train, n_val=n_val,
                                        **(fixture or {}))
        fixture_s = time.monotonic() - t0
        data_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp) for f in fs)

        def edit(raw):
            point_at(raw, paths)
            raw.update(output_dir=os.path.join(tmp, "out"), num_train_steps=steps, valid_steps=0,
                       **(overrides or {}))

        with cli_run(paths, tmp, "retrieval-msrvtt.json", edit) as cfg_path:
            cfg = load_config(cfg_path)
            spec = parse_task(cfg.data_train[0].task)
            with record_trainers(sync, cuda) as runs, record_validations(sync) as evals, \
                    record_checkpoints(sync, lambda st: restored.update(check_same_state(st, saved))) as ck, \
                    record_ln_calls() as (sigs_fwd, sigs_bwd), record_fine_calls() as fine_calls:
                K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
                first = main(["--config", cfg_path, "--async_checkpoint", "true", "--valid_steps", str(steps // 2),
                              *dev_args])
                saved.update(snapshot_state(first.state))
                run1 = {"step": first.state.step, "updates": first.state.optimizer.gradient_step,
                        "history": list(first.history)}
                del first, runs[0]["trainer"]  # run 1's model leaves the card before run 2
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
                second = main(["--config", cfg_path, "--resume", "true", "--num_train_steps", str(2 * steps),
                               "--async_checkpoint", "true", *dev_args])
                launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
            disk = shutil.disk_usage(tmp)
            ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(os.path.join(tmp, "out", "ckpt")) for f in fs)
            # one collated training batch of clip spans through the device fbank
            ds = build_dataset(cfg.data_train[0], cfg.model, build_tokenizers(cfg.model), training=True)
            batch = valor_collate([ds[i] for i in range(cfg.data_train[0].batch_size)])
            fbank = check_device_fbank(batch, cfg.model, device)
            if root:
                shutil.rmtree(os.path.join(tmp, "out"))

    r1, r2 = runs
    t2 = second
    if run1["step"] != steps or run1["updates"] != steps:
        raise AssertionError(f"run 1 ended at micro-step {run1['step']}, {run1['updates']} updates")
    resumed_first = t2.history[0][0]
    if resumed_first != steps + 1 or t2.state.optimizer.gradient_step != 2 * steps \
            or t2.state.optimizer.count != 2 * steps:
        raise AssertionError(f"run 2 began at micro-step {resumed_first}, ended with "
                             f"{t2.state.optimizer.gradient_step} updates")
    if not restored:
        raise AssertionError("run 2 restored nothing")
    for history in (run1["history"], t2.history):
        if len(history) != steps or not all(np.isfinite(v) for h in history for v in h[2].values()):
            raise AssertionError(f"{len(history)} steps logged, or a non-finite loss: {history}")
    eval_batches = -(-n_val // cfg.data_val[0].batch_size)
    # run 1: before training, at steps // 2, at steps (the periodic and the final one); run 2: before and final
    if len(evals) != 6 or any(n != n_val for n, _, _ in evals):
        raise AssertionError(f"validations (items) {[n for n, _, _ in evals]}, expected 6 of {n_val}")
    for _, _, report in evals:
        if not all(np.isfinite(v) for v in report.values()) or "ravg" not in report:
            raise AssertionError(f"validation report {report}")
    per_step = expected_train_ln_launches(t2.state.model, spec)
    fine_groups = spec.contra_groups if cfg.model.contra_type == "fine" else ()
    expected = ((per_step * (2 * steps + len(evals) * eval_batches), per_step * 2 * steps,
                 len(evals) * len(fine_groups)) if cuda else (0, 0, 0))
    if launches != expected:
        raise AssertionError(f"launches (ln fwd, ln bwd, fine_score) {launches} != {expected}")
    if cuda:  # run 2's state, saved again with the next update queued at once
        with tempfile.TemporaryDirectory(prefix="valor_snapshot_") as snap_dir:
            snapshot_check = check_async_snapshot(t2.state, snap_dir)

    def timing(rec):
        step_s = np.diff([rec["start"]] + rec["stamps"])
        wait_s = np.diff([0.0] + rec["waits"])
        return step_s, wait_s

    (s1, w1), (s2, w2) = timing(r1), timing(r2)
    timed = np.concatenate([s1[2:], s2[2:]])  # the first two steps of each run are warm-up
    # the asynchronous saves: run 1 saves at steps // 2 (the first, which allocates the pinned buffers),
    # twice at steps (periodic and final; the second waits for the first's write), run 2 at 2 * steps
    writes = [w for sv in ck["savers"] for w in sv.writes]
    if [w[0] for w in writes] != [steps // 2, steps, steps, 2 * steps] or len(ck["save_s"]) != 4:
        raise AssertionError(f"asynchronous writes {writes}, saves {ck['save_s']}")
    # steps that began after the step-5 save returned and before its write was durable (the step after the
    # save spans the validation and the save themselves); run 2's steps, which overlap no write, beside them
    _, begun, durable = writes[0]
    during = [i for i in range(1, len(r1["stamps"])) if begun <= r1["stamps"][i - 1] < durable]
    stall = float((w1[2:].sum() + w2[2:].sum()) / timed.sum())
    batch_size = cfg.data_train[0].batch_size
    median = float(np.median(timed))
    summary = {
        "config": "configs/retrieval-msrvtt.json", "task": cfg.data_train[0].task, "batch": batch_size,
        "frames": cfg.data_train[0].video_sample_num, "clips": cfg.data_train[0].audio_sample_num,
        "train_items": n_train, "val_items": n_val, "dataset_written_s": fixture_s,
        "dataset_bytes": data_bytes, "steps_per_run": steps, "timed_steps": int(len(timed)),
        "median_step_s": median, "samples_per_s": batch_size / median,
        "step_s_run1": [float(v) for v in s1], "step_s_run2": [float(v) for v in s2],
        "data_wait_s_run1": [float(v) for v in w1], "data_wait_s_run2": [float(v) for v in w2],
        "data_stall_share": stall, "device_idle_share": "not measured (no profiler trace in this phase)",
        "max_memory_allocated_gib": [r1["peak"] / 2**30, r2["peak"] / 2**30],
        "async_checkpoint": True, "save_blocked_s": ck["save_s"], "save_blocked_first_s": ck["save_s"][0],
        "save_blocked_later_s": ck["save_s"][1:], "finish_wait_s": ck["finish_s"],
        "write_s": [float(d - b) for _, b, d in writes], "steps_while_writing": [i + 1 for i in during],
        "step_s_while_writing": [float(s1[i]) for i in during],
        "step_s_without_write_median": float(np.median(s2[2:])),
        "restore_s": ck["restore_s"], "checkpoint_bytes_on_disk": ckpt_bytes,
        "disk_free_bytes": disk.free, "restored_equals_saved": restored,
        "snapshot_not_overtaken": snapshot_check if cuda else "not run (CPU)",
        "validation_s": [s_ for _, s_, _ in evals], "validation_items_per_s": [n / s_ for n, s_, _ in evals],
        "resumed_first_step": resumed_first, "resumed_update_count": t2.state.optimizer.gradient_step,
        "contra_loss_run1": [h[2]["contra_loss"] for h in run1["history"]],
        "contra_loss_run2": [h[2]["contra_loss"] for h in t2.history],
        "report_final": evals[-1][2], "device_fbank": fbank,
        "layernorm_launches_fwd_bwd": launches[:2], "fine_score_launches": launches[2],
        "ln_per_forward": per_step,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
        "fine_score_calls": sorted({tuple(s_) for s_, _ in fine_calls}), "paths": paths,
    }
    if synthetic:
        summary["synthetic_samples_per_s"] = synthetic["samples_per_s"]
        summary["disk_over_synthetic"] = summary["samples_per_s"] / synthetic["samples_per_s"]
    log("cli_train " + json.dumps(summary))
    return summary


# -- phases 7b, 15 and 16: caption and QA finetuning ---------------------------
def phase_cap_qa_card_vs_cpu(device: str = "cuda"):
    """The tiny config (fp32, TF32 off) on the card against the CPU for the
    caption and QA slice: one ``cap%tva`` and one ``qa%tva`` training step (a
    multi-answer batch) to phase 7's tolerances, and sequences decoded from
    clip-span waveforms through the device fbank (``audio_waveforms``), greedy
    and beam 3 captions and greedy answers to tiled questions, equal token for
    token."""
    import torch

    from valor_tpu_torch.data.fbank import clip_span_samples
    from valor_tpu_torch.data.synthetic import qa_batch
    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.models.bridge import init_params, load_model

    steps = {t: phase_train_card_vs_cpu(device, t) for t in ("cap%tva", "qa%tva")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_config()
    sd = init_params(cfg, seed=0, device="cpu")
    models = {"cpu": load_model(cfg, sd, "cpu"), device: load_model(cfg, {k: v.to(device) for k, v in sd.items()},
                                                                    device)}
    rng = np.random.RandomState(3)
    media = {"video_pixels": rng.randint(0, 256, size=(4, 2, 32, 32, 3), dtype=np.uint8),
             "audio_waveforms": (rng.randn(4, 1, clip_span_samples(32)) * 0.3).astype(np.float32),
             "audio_valid_frames": np.array([[32], [20], [-1], [32]], np.int32)}
    qa = qa_batch(cfg, 4, frames=2, clips=1, n_question=8, seed=4)
    questions = dict(media, question_prompt=qa["question_prompt"], tile_index=qa["tile_index"])
    out = {}
    for name, batch, groups, kw in (
        ("caption_greedy", media, ("tva",), dict(max_len=6)),
        ("caption_beam3", media, ("tva",), dict(max_len=6, beam_size=3)),
        ("qa_greedy", questions, ("tva", "ta"), dict(max_len=4)),
    ):
        seqs = {}
        for d, m in models.items():
            res = Generator(m).generate(batch, groups, **kw)
            seqs[d] = np.concatenate([res[f"generated_sequences_{g}"].cpu().numpy() for g in groups])
        if not np.array_equal(seqs["cpu"], seqs[device]):
            raise AssertionError(f"{name}: card {seqs[device].tolist()} != cpu {seqs['cpu'].tolist()}")
        out[name] = seqs[device].tolist()
    torch.backends.cudnn.allow_tf32 = True
    log("card vs cpu caption and QA " + json.dumps({"steps": {t: {k: v for k, v in r.items() if k != "task"}
                                                               for t, r in steps.items()},
                                                     "equal_sequences": out}))
    return {"steps": steps, "sequences": out}


@contextlib.contextmanager
def record_generative_validations(sync):
    """Yields a list that fills with one record a ``validate_cap`` or
    ``validate_qa`` call: its kind, evaluation items (ids) and generated rows,
    seconds between two synchronisations, the seconds inside ``caption_eval``
    and, within it, ``meteor_lite``, and the report."""
    from valor_tpu_torch.eval import cococaption as CC
    from valor_tpu_torch.eval import validate as V

    calls = []
    fns = {"cap": V.validate_cap, "qa": V.validate_qa}
    eval0, meteor0 = V.caption_eval, CC.meteor_lite
    timers = {"caption_eval_s": 0.0, "meteor_lite_s": 0.0}

    def timed(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                timers[key] += time.perf_counter() - t0
        return wrapped

    def make(kind, fn0):
        def fn1(model, loader, *a, **kw):
            seen = {"items": 0, "rows": 0}

            def counted(it):
                for b in it:
                    seen["items"] += len(b["ids"])
                    seen["rows"] += len(b["tile_index"]) if b.get("tile_index") is not None else len(b["ids"])
                    yield b

            timers.update(caption_eval_s=0.0, meteor_lite_s=0.0)
            sync()
            t0 = time.perf_counter()
            report = fn0(model, counted(loader), *a, **kw)
            sync()
            calls.append(dict(kind=kind, seconds=time.perf_counter() - t0, report=report, **seen, **timers))
            return report
        return fn1

    V.validate_cap, V.validate_qa = make("cap", fns["cap"]), make("qa", fns["qa"])
    V.caption_eval, CC.meteor_lite = timed(eval0, "caption_eval_s"), timed(meteor0, "meteor_lite_s")
    try:
        yield calls
    finally:
        V.validate_cap, V.validate_qa = fns["cap"], fns["qa"]
        V.caption_eval, CC.meteor_lite = eval0, meteor0


@contextlib.contextmanager
def record_batch_rows():
    """Yields a list that fills with (text rows, media rows) of every batch
    that ``Trainer`` hands ``train_step``."""
    from valor_tpu_torch.train import trainer as T

    rows, step0 = [], T.train_step

    def step1(state, batch, *a, **kw):
        media = batch.get("video_pixels", batch.get("audio_waveforms"))
        rows.append((int(batch["bert_tokens"].shape[0]), int(media.shape[0])))
        return step0(state, batch, *a, **kw)

    T.train_step = step1
    try:
        yield rows
    finally:
        T.train_step = step0


def phase_cli_finetune(kind: str, paths: dict, steps: int = 10, device: str = "cuda", overrides=None,
                       synthetic=None, out_dir=None, batch_size=None, label=None, sharp_start=False):
    """``valor_tpu_torch.cli.train`` from disk at the full width of
    ``configs/caption-msrvtt.json`` (``kind`` "cap") or ``configs/qa-msrvtt.json``
    ("qa"), with only the dataset paths (``paths``, a ``data/synthetic.py``
    writer's), ``output_dir``, ``num_train_steps`` and ``valid_steps`` changed:
    the config's evaluation before training (``first_eval``), ``steps`` steps,
    then the trainer's final validation over the evaluation ids, whose figures
    are checked and reported.
    ``overrides`` shrink the model for a CPU rehearsal (device "cpu");
    ``synthetic`` is a from-disk summary whose samples/s this run's is set against;
    ``out_dir``, where given, is the run's ``output_dir`` and stays (phase 17
    takes its weights from phase 15's); ``batch_size``, where given, replaces
    the train flows' (phase d: the largest that fits).  With ``sharp_start``
    the run starts (``--checkpoint``) from the sharp init law's weights
    (``data/synthetic.py:write_sharp_init_run``), whose captions depend on their
    media, where ``cli.train`` alone draws the JAX package's law: phases 17, 20
    and 21 take phase 15's run, and their checks that served rows are the
    in-process decode's rows need captions that differ by media."""
    import os

    import torch

    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    name = {"cap": "caption-msrvtt.json", "qa": "qa-msrvtt.json"}[kind]

    def edit(raw):
        point_at(raw, paths)
        raw.update(output_dir=out_dir or os.path.join(tmp, "out"), num_train_steps=steps, valid_steps=0,
                   **(overrides or {}))
        for flow in raw["data_cfg"]["train"] if batch_size else ():
            flow["batch_size"] = batch_size

    with tempfile.TemporaryDirectory(prefix=f"valor_cli_{kind}_") as tmp, \
            cli_run(paths, tmp, name, edit) as cfg_path:
        cfg = load_config(cfg_path)
        spec = parse_task(cfg.data_train[0].task)
        start = []
        if sharp_start:
            from valor_tpu_torch.data.synthetic import write_sharp_init_run

            start = ["--checkpoint", write_sharp_init_run(os.path.join(tmp, "sharp_init"), cfg.model)]
        with record_trainers(sync, cuda) as runs, record_generative_validations(sync) as evals, \
                record_batch_rows() as rows, record_ln_calls() as (sigs_fwd, sigs_bwd):
            K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
            trainer = main(["--config", cfg_path, *start, *([] if cuda else ["--device", device])])
            launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
        out_dir = cfg.train.output_dir
        results = os.path.join(out_dir, f"results_test_{cfg.data_val[0].datasets[0].name}")
        dumps = {f: json.load(open(os.path.join(results, f))) for f in sorted(os.listdir(results))}
        with open(paths["val_txt"]) as f:
            val_txt = json.load(f)

    rec, history = runs[0], list(trainer.history)
    model = trainer.state.model
    if trainer.state.optimizer.gradient_step != steps or len(history) != steps:
        raise AssertionError(f"{len(history)} steps logged, {trainer.state.optimizer.gradient_step} updates")
    loss_key = "caption_loss" if kind == "cap" else "qa_loss"
    if not all(np.isfinite(h[2][loss_key]) and np.isfinite(h[2]["grad_norm"]) for h in history):
        raise AssertionError(f"non-finite loss: {history}")
    n_evals = 1 + bool(cfg.train.first_eval)  # the config's evaluation before training, and the final one
    if len(evals) != n_evals or any(e["items"] != len(val_txt) for e in evals):
        raise AssertionError(f"validations {[(e['kind'], e['items']) for e in evals]}, "
                             f"expected {n_evals} of {len(val_txt)}")
    ev = evals[-1]
    report = ev["report"]
    group = spec.caption_groups[0]
    if kind == "cap":
        keys = ("Bleu_4", "CIDEr", "METEOR", "ROUGE_L")
        if not all(k in report and np.isfinite(report[k]) for k in keys):
            raise AssertionError(f"caption report {report}")
        dump = dumps.get(f"step_{steps}_{group}.json", [])
        if len(dump) != len(val_txt):
            raise AssertionError(f"step_{steps}_{group}.json holds {len(dump)} captions, not {len(val_txt)}")
    else:
        n_questions = sum(len(v) for v in val_txt.values())
        if "accuracy" not in report or not np.isfinite(report["accuracy"]) or ev["rows"] != n_questions:
            raise AssertionError(f"QA report {report}, {ev['rows']} rows for {n_questions} questions")
        for f in (f"step{steps}_gt.json", f"step{steps}_{group}_pred.json"):
            if len(dumps.get(f, [])) != n_questions:
                raise AssertionError(f"{f} holds {len(dumps.get(f, []))} rows, not {n_questions}")
    per_step = expected_train_ln_launches(model, spec)
    val_batches = -(-len(val_txt) // cfg.data_val[0].batch_size)
    per_val_batch = expected_ln_launches(model, prompt=kind == "qa")
    expected = ((per_step * steps + n_evals * val_batches * per_val_batch, per_step * steps, 0)
                if cuda else (0, 0, 0))
    if launches != expected:
        raise AssertionError(f"launches (ln fwd, ln bwd, fine_score) {launches} != {expected}")

    step_s = np.diff([rec["start"]] + rec["stamps"])
    wait_s = np.diff([0.0] + rec["waits"])
    timed = step_s[2:]  # steps 3-10: the first two are warm-up
    batch_size = cfg.data_train[0].batch_size
    median = float(np.median(timed))
    summary = {
        "config": f"configs/{name}", "task": cfg.data_train[0].task, "batch": batch_size,
        "frames": cfg.data_train[0].video_sample_num, "clips": cfg.data_train[0].audio_sample_num,
        "val_frames": cfg.data_val[0].video_sample_num, "train_items": len(json.load(open(paths["train_ids"]))),
        "val_items": len(val_txt), "steps": steps, "median_step_s": median,
        "samples_per_s": batch_size / median, "step_s": [float(v) for v in step_s],
        "data_wait_s": [float(v) for v in wait_s], "data_stall_share": float(wait_s[2:].sum() / timed.sum()),
        "device_idle_share": "not measured (no profiler trace in this phase)",
        "max_memory_allocated_gib": rec["peak"] / 2**30,
        "train_rows_text_media": sorted(set(rows)),
        "loss": [h[2][loss_key] for h in history],
        "validations": [{k: e[k] for k in ("items", "rows", "seconds", "caption_eval_s", "meteor_lite_s")}
                        for e in evals],
        "report": report, "dumps": {f: len(v) for f, v in dumps.items()},
        "layernorm_launches_fwd_bwd": launches[:2], "fine_score_launches": launches[2],
        "ln_per_step": per_step, "ln_per_val_batch": per_val_batch, "val_batches": val_batches,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
    }
    if kind == "cap":
        summary["captions_per_s"] = ev["items"] / ev["seconds"]
        summary["caption_eval_share"] = ev["caption_eval_s"] / ev["seconds"]
        summary["beam_size"], summary["max_len"] = cfg.model.beam_size, cfg.model.max_generation_len
    else:
        summary["answers_per_s"] = ev["rows"] / ev["seconds"]
        summary["beam_size"], summary["max_len"] = cfg.model.beam_size_qa, cfg.model.max_generation_len
    summary["output_dir"] = out_dir
    if synthetic:
        summary["retrieval_from_disk_samples_per_s"] = synthetic["samples_per_s"]
    summary["model"] = {k: getattr(cfg.model, k) for k in ("video_encoder_type", "txt_encoder_type")}
    log(f"{label or 'cli_' + kind} " + json.dumps(summary))
    return summary


def phase_cap_qa_from_disk(n_train: int = 320, n_val: int = 128, steps: int = 10, fixture=None, overrides=None,
                           device: str = "cuda", synthetic=None, root=None):
    """Phases 15 and 16: a seeded MSR-VTT-shaped dataset (``n_train`` training
    and ``n_val`` evaluation ids, media written once, caption and QA files
    beside them) through ``phase_cli_finetune`` for ``cap`` and then ``qa``.
    ``fixture`` and ``overrides`` shrink the media and the model for a CPU
    rehearsal.  With ``root`` the caption files and the caption run's
    ``output_dir`` stay there for phase 17 (under "paths" and "output_dir" in
    the caption summary)."""
    import os

    import torch

    from valor_tpu_torch.data.synthetic import write_caption_dataset, write_qa_dataset

    with (contextlib.nullcontext(root) if root else tempfile.TemporaryDirectory(prefix="valor_cap_qa_")) as tmp:
        t0 = time.monotonic()
        cap = write_caption_dataset(os.path.join(tmp, "cap"), n_train, n_val, **(fixture or {}))
        qa = write_qa_dataset(os.path.join(tmp, "qa"), n_train, n_val, media=cap)
        written = {"dataset_written_s": time.monotonic() - t0,
                   "dataset_bytes": sum(os.path.getsize(os.path.join(d, f))
                                        for d, _, fs in os.walk(tmp) for f in fs)}
        out = {}
        for kind, paths in (("cap", cap), ("qa", qa)):
            keep = os.path.join(tmp, f"{kind}_out") if root and kind == "cap" else None
            out[kind] = dict(phase_cli_finetune(kind, paths, steps, device, overrides, synthetic, keep,
                                                sharp_start=kind == "cap"), paths=paths, **written)
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    return out["cap"], out["qa"]


# -- phases 7c, 17 and 18: SCST, task prompts, validate_pt, the context-K/V decode --
def _ln_count(*mods) -> int:
    from valor_tpu_torch.ops.layers import LayerNorm

    return sum(isinstance(x, LayerNorm) for m in mods if m is not None for x in m.modules())


def expected_scst_ln_launches(model, spec) -> tuple:
    """LayerNorm launches (forward, backward) of one SCST batch: the towers of
    the caption groups and the adapters once (the media are encoded once,
    without autograd), then for each group a greedy and a sampled rollout of
    ``max_generation_len`` decode steps and the REINFORCE forward, each a pass
    of the fusion encoder and its head (one more LayerNorm a pass with the
    caption prompt), and the REINFORCE backward of the same.  VALOR-base at 30
    tokens: 26 + 25 + 61 * 38 = 2369 forward and 38 backward."""
    v, a = spec.uses_video, spec.uses_audio
    encode = (_ln_count(model.clip_vision, getattr(model, "video_adapter_ln", None)) * v
              + _ln_count(model.audio_encoder, getattr(model, "audio_adapter_ln", None)) * a)
    step = _ln_count(model.multimodal_encoder, model.cls_head) + bool(model.cfg.use_task_prompt)
    groups = len(spec.caption_groups)
    return encode + groups * (2 * model.cfg.max_generation_len + 1) * step, groups * step


def _write_annotations(root: str, ids, seed: int = 6) -> dict:
    """A WordPiece vocabulary (``data/synthetic.py``) and ``{id: [3 captions]}``
    of its words; returns their paths ("vocab", "ann")."""
    import os

    from valor_tpu_torch.data.synthetic import WORDS, write_tokenizer_files

    paths = write_tokenizer_files(root)
    rng = np.random.RandomState(seed)
    paths["ann"] = os.path.join(root, "ann.json")
    with open(paths["ann"], "w") as f:
        json.dump({i: [" ".join(rng.choice(WORDS, size=rng.randint(4, 9))) for _ in range(3)] for i in ids}, f)
    return paths


def phase_scst_prompt_card_vs_cpu(device: str = "cuda"):
    """The tiny config (fp32, TF32 off) on the card against the CPU for the SCST,
    task-prompt and context-K/V slice: one ``Trainer.scst_step`` of
    ``cap%tva%tv`` (dropout 0.1 in the config, which the update must switch
    off) with the same greedy and sampled rollouts patched in on both devices
    (rewards equal, losses within 1e-4, every gradient and updated parameter to
    phase 7's tolerances, the LayerNorm launches those of the path); greedy and
    beam-3 captions with ``multimodal_use_cross_attn=False`` and the caption
    prompt, through the context-K/V decode, equal token for token (its logits
    within 1e-4 of the full forward's and of the CPU's); one prompted
    ``pt_contra%tva%tv_caption%tva%tv`` step (phase 7's check); and one caption
    served with the caption prompt equal to a direct ``Generator.generate``."""
    import torch

    from valor_tpu_torch.core.config import Config, TrainConfig
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import WORDS, pretrain_batch
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.generate import Generator, make_fusion_decoder
    from valor_tpu_torch.eval.scorer import Scorer
    from valor_tpu_torch.models.bridge import init_params, load_model, train_model
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig
    from valor_tpu_torch.train import trainer as T
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, to_device

    cuda = device == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {}

    # one SCST update on both devices, the rollouts patched in
    cfg = dataclasses.replace(tiny_config(), caption_type="unimlm", dropout=0.1, scst_finetuning=True)
    lr = 1e-3
    tcfg = TrainConfig(learning_rate=lr, clip_lr=lr, clip_lr_text=lr, num_train_steps=10, grad_norm=0.5)
    sd = init_params(cfg, seed=0, device="cpu")
    spec = parse_task("cap%tva%tv")
    ids = [f"video{i}" for i in range(4)]
    data = pretrain_batch(cfg, 4, frames=2, clips=1, n_txt=8, seed=5)
    rng = np.random.RandomState(8)
    rollouts = {}
    for mode in ("greedy", "sample"):
        seqs = np.full((4, cfg.max_generation_len), 102, np.int64)
        for r, n in enumerate(rng.randint(1, cfg.max_generation_len + 1, size=4)):
            seqs[r, :n] = 106 + rng.randint(0, len(WORDS), size=n)  # a full row has no EOS
        rollouts[mode] = seqs
    decode0 = T._decode

    def patched(model, caption_type, max_len, beam_size, mode, prompt, v, a, generator):
        s = torch.from_numpy(rollouts[mode]).to(model.device).int()
        return s, torch.zeros(s.shape, device=model.device)

    res = {}
    T._decode = patched
    try:
        with tempfile.TemporaryDirectory(prefix="valor_scst_tiny_") as tmp:
            files = _write_annotations(tmp, ids)
            scorer = Scorer(files["ann"], ids, BertTokenizer(files["vocab"]))
            for dev in ("cpu", device):
                model = train_model(cfg, {k: v.to(dev) for k, v in sd.items()}, dev)
                state = TrainState(model, build_optimizer(model, tcfg))
                grads, update0 = [], state.optimizer.update

                def update(g, update0=update0, grads=grads):
                    grads.append([x.cpu() for x in g])
                    return update0(g)

                state.optimizer.update = update
                trainer = T.Trainer(Config(model=cfg, train=tcfg), state, [], scorer=scorer)
                fwd, bwd = K.LAUNCHES, K.LAUNCHES_BWD
                metrics = trainer.scst_step(to_device(data, dev), ids, spec)
                res[dev] = ({k: float(v) for k, v in metrics.items()}, grads,
                            [p.detach().cpu() for p in model.parameters()],
                            (K.LAUNCHES - fwd, K.LAUNCHES_BWD - bwd), state.step, model.training)
    finally:
        T._decode = decode0
    (m_cpu, g_cpu, p_cpu, _, step_cpu, _), (m_gpu, g_gpu, p_gpu, launches, step_gpu, training) = \
        res["cpu"], res[device]
    rewards = {k: m_gpu[k] for k in m_gpu if k.startswith("scst_reward")}
    if rewards != {k: m_cpu[k] for k in rewards} or len(rewards) != 2:
        raise AssertionError(f"SCST rewards card {m_gpu} vs cpu {m_cpu}")
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) for k in m_gpu if k.startswith("caption_loss"))
    if loss_err > 1e-4 or step_cpu != step_gpu or step_gpu != 2 or not training:
        raise AssertionError(f"SCST losses {m_gpu} vs {m_cpu}, steps {step_gpu} / {step_cpu}, "
                             f"training mode {training}")
    names = [n for n, _ in train_model(cfg, sd, "cpu").named_parameters()]
    grad_err = 0.0
    for update_gpu, update_cpu in zip(g_gpu, g_cpu):
        for name, a, b in zip(names, update_gpu, update_cpu):
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                raise AssertionError(f"card vs cpu SCST gradient of {name}: "
                                     f"max diff {float((a - b).abs().max())}")
            grad_err = max(grad_err, float((a - b).abs().max()))
    diff = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(p_gpu, p_cpu)])
    within = float((diff <= 2e-2 * lr).float().mean())
    if len(g_gpu) != 2 or float(diff.max()) > lr or within < 0.999:
        raise AssertionError(f"card vs cpu SCST updates: {len(g_gpu)} updates, max diff {float(diff.max())}, "
                             f"{within:.5f} within 2% of a step")
    probe = train_model(cfg, sd, "cpu")
    step_ln = _ln_count(probe.multimodal_encoder, probe.cls_head)
    want = (_ln_count(probe.clip_vision, probe.audio_encoder) + 2 * step_ln, 2 * step_ln) if cuda else (0, 0)
    if launches != want:  # the rollouts are patched: the encode and two REINFORCE updates
        raise AssertionError(f"SCST step launched {launches} layernorm kernels (fwd, bwd), not {want}")
    summary["scst_step"] = {"task": spec.raw, "metrics_cuda": m_gpu, "metrics_cpu": m_cpu,
                            "max_loss_diff": loss_err, "max_grad_diff": grad_err,
                            "max_param_diff": float(diff.max()), "params_within_2pct_step": within,
                            "updates": len(g_gpu), "layernorm_launches_fwd_bwd": launches}

    # the context-K/V decode with the caption prompt
    cfg2 = dataclasses.replace(tiny_config(), multimodal_use_cross_attn=False)
    sd2 = init_params(cfg2, seed=0, device="cpu")
    models = {"cpu": load_model(cfg2, sd2, "cpu"),
              device: load_model(cfg2, {k: v.to(device) for k, v in sd2.items()}, device)}
    prompt = np.asarray([[101, 110, 111, 112, 113, 102]], np.int64)
    rng = np.random.RandomState(9)
    media = {"video_pixels": rng.randint(0, 256, size=(4, 2, 32, 32, 3), dtype=np.uint8),
             "audio_spectrograms": rng.randn(4, 1, 16, 32).astype(np.float32)}
    batch = dict(media, prompt_tokens_caption=prompt)
    m = models[device]
    step = _ln_count(m.multimodal_encoder, m.cls_head)
    # the encode, the context once (the prompt's embedding LN and the layers', no head), then the steps
    ctx_launches = (_ln_count(m.clip_vision, m.audio_encoder) + _ln_count(m.multimodal_encoder)
                    + step * cfg2.max_generation_len)
    seqs_out = {}
    for beam in (1, 3):
        seqs = {}
        for d, mod in models.items():
            fwd = K.LAUNCHES
            seqs[d] = Generator(mod).generate(batch, ("tva",), max_len=cfg2.max_generation_len,
                                              beam_size=beam)["generated_sequences_tva"].cpu().numpy()
            if d == device and cuda and K.LAUNCHES - fwd != ctx_launches:
                raise AssertionError(f"context-K/V decode (beam {beam}) launched {K.LAUNCHES - fwd} "
                                     f"layernorm kernels, not {ctx_launches}")
        if not np.array_equal(seqs["cpu"], seqs[device]):
            raise AssertionError(f"context-K/V beam {beam}: card {seqs[device].tolist()} != cpu "
                                 f"{seqs['cpu'].tolist()}")
        seqs_out[f"beam{beam}"] = seqs[device].tolist()
    buf = torch.from_numpy(rng.randint(106, 512, size=(4, 8))).long()
    buf[:, 0] = 101
    mask = (torch.arange(8)[None] <= 4).float().expand(4, 8)
    logits = {}
    with torch.inference_mode():
        for d, mod in models.items():
            v = mod.video_fusion_input(mod.encode_video(torch.from_numpy(media["video_pixels"]).to(d)))
            a = mod.audio_fusion_input(mod.encode_audio(torch.from_numpy(media["audio_spectrograms"]).to(d)))
            p = torch.from_numpy(prompt).to(d)
            logits[d] = make_fusion_decoder(mod, p.expand(4, -1), v, a)(buf.to(d), mask.to(d)).cpu()
            if d == device:
                full = mod.fusion_logits(buf.to(d), p, v, a, True, False, mask.to(d)).cpu()
    ctx_err = float((logits[device] - full).abs().max())
    dev_err = float((logits[device] - logits["cpu"]).abs().max())
    if ctx_err > 1e-4 or dev_err > 1e-4:
        raise AssertionError(f"context-K/V logits: {ctx_err} from the full forward, {dev_err} card vs cpu")
    summary["ctx_decode"] = {"equal_sequences": seqs_out, "logits_vs_full_forward": ctx_err,
                             "logits_card_vs_cpu": dev_err, "layernorm_launches_a_decode": ctx_launches}

    # a prompted pretraining step
    summary["prompted_pt_step"] = phase_train_card_vs_cpu(device, "pt_contra%tva%tv_caption%tva%tv",
                                                          prompts=True)

    # a caption served with the caption prompt
    cfg3 = tiny_config()
    m3 = load_model(cfg3, init_params(cfg3, seed=0, device=device), device)
    item = {"video_pixels": media["video_pixels"][0], "audio_spectrograms": media["audio_spectrograms"][0]}
    serve_cfg = ServeConfig(buckets=(1,), max_wait_ms=0, group="tva", max_len=cfg3.max_generation_len)
    with InferenceEngine(m3, serve_cfg, prompts={"tva": prompt}) as engine:
        served = engine.submit(item).result(timeout=300)["sequences"]
    one = {k: v[None] for k, v in item.items()}
    direct = Generator(m3).generate(dict(one, prompt_tokens_caption=prompt), ("tva",),
                                    max_len=cfg3.max_generation_len)["generated_sequences_tva"][0]
    plain = Generator(m3).generate(one, ("tva",), max_len=cfg3.max_generation_len)["generated_sequences_tva"][0]
    if not np.array_equal(np.asarray(served), direct.cpu().numpy()):
        raise AssertionError(f"served prompted caption {np.asarray(served).tolist()} != direct "
                             f"{direct.tolist()}")
    summary["served_prompted_caption"] = {"sequence": np.asarray(served).tolist(),
                                          "without_prompt": plain.tolist()}
    torch.backends.cudnn.allow_tf32 = True
    log("card vs cpu SCST, prompts, context-K/V " + json.dumps(summary))
    return summary


@contextlib.contextmanager
def record_scst(sync):
    """Yields a dict that fills with the SCST run's parts: (part, host start,
    seconds between two synchronisations) of every media encode, greedy and
    sampled rollout, host reward and REINFORCE update; every reward array the
    ``Scorer`` gave (the global batch's across ranks); the seconds each
    ``Scorer`` took to build; the weights that ``--pretrain_dir`` restored
    (``cli/train.py:restore_weights``), checked against the model at the first
    SCST step; and, per parameter, whether any update gave it a non-zero
    gradient.  It launches no kernel itself but the checks' reductions."""
    import torch

    import valor_tpu_torch.cli.train as CT
    from valor_tpu_torch.eval import generate as G
    from valor_tpu_torch.eval import scorer as S
    from valor_tpu_torch.train import step as TS
    from valor_tpu_torch.train import trainer as T

    rec = {"parts": [], "scorer_build_s": [], "restored": {}, "first_step_equal": None, "nonzero": None,
           "rewards": []}
    saved = (G.Generator.encode, T._decode, S.Scorer.__call__, S.Scorer.__init__, T.scst_update,
             T.Trainer.scst_step, CT.restore_weights, TS.param_grads)

    def timed(part, fn):
        def wrapped(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            rec["parts"].append((part(*a, **kw) if callable(part) else part, t0, time.perf_counter() - t0))
            return out
        return wrapped

    def init(self, *a, **kw):
        t0 = time.perf_counter()
        saved[3](self, *a, **kw)
        rec["scorer_build_s"].append(time.perf_counter() - t0)

    def reward(self, ids, hyps):
        out = saved[2](self, ids, hyps)
        rec["rewards"].append([float(v) for v in out])
        return out

    def restore(path, step=None):
        payload = saved[6](path, step)
        rec["restored"] = dict(payload["params"])
        return payload

    def scst_step(self, batch, ids, spec):
        if rec["first_step_equal"] is None:
            now = self.state.model.state_dict()
            rec["first_step_equal"] = [k for k, v in rec["restored"].items()
                                       if not torch_equal(now[k].detach().cpu(), v)] == [] and \
                len(rec["restored"]) == len(now)
        return saved[5](self, batch, ids, spec)

    def grads(total, params):
        g = saved[7](total, params)
        flags = torch.stack([x.ne(0).any() for x in g])
        rec["nonzero"] = flags if rec["nonzero"] is None else rec["nonzero"] | flags
        return g

    G.Generator.encode = timed("encode", saved[0])
    T._decode = timed(lambda model, ct, ml, bs, mode, *a: f"{mode}_rollout", saved[1])
    S.Scorer.__call__ = timed("host_reward", reward)
    S.Scorer.__init__ = init
    T.scst_update = timed("update", saved[4])
    T.Trainer.scst_step, CT.restore_weights, TS.param_grads = scst_step, restore, grads
    try:
        yield rec
    finally:
        (G.Generator.encode, T._decode, S.Scorer.__call__, S.Scorer.__init__, T.scst_update,
         T.Trainer.scst_step, CT.restore_weights, TS.param_grads) = saved


def phase_cli_scst(paths: dict, pretrain_dir: str, steps: int = 10, device: str = "cuda", overrides=None,
                   synthetic=None):
    """SCST caption finetuning from disk through ``cli.train``'s ``main`` at the
    full width of ``configs/caption-msrvtt.json`` (``cap%tva``, batch 64, 4
    frames, 1 clip, beam 3, 30 tokens, bf16) with ``--scst_finetuning true``
    and ``--pretrain_dir`` the caption run of phase 15 (``pretrain_dir``), on
    its dataset (``paths``): ``steps`` SCST steps, then the final validation
    (the config's evaluation before training is off: it would repeat phase
    15's last).  Checks: the restored weights equal the caption run's saved
    ones; every loss and reward finite; every parameter of the fusion stack
    and head took a gradient, the towers none (they encode without autograd),
    and a parameter without one moved only by weight decay; the LayerNorm
    launches those of the path, no fine-score launch.  ``overrides`` shrink
    the run for a CPU rehearsal."""
    import os

    import torch

    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def edit(raw):
        point_at(raw, paths)
        raw.update(output_dir=os.path.join(tmp, "scst_out"), num_train_steps=steps, valid_steps=0,
                   first_eval=False, **(overrides or {}))

    with tempfile.TemporaryDirectory(prefix="valor_cli_scst_") as tmp, \
            cli_run(paths, tmp, "caption-msrvtt.json", edit) as cfg_path:
        argv = ["--config", cfg_path, "--scst_finetuning", "true", "--pretrain_dir", pretrain_dir]
        cfg = load_config(cfg_path)
        spec = parse_task(cfg.data_train[0].task)
        with record_trainers(sync, cuda) as runs, record_generative_validations(sync) as evals, \
                record_scst(sync) as scst, record_ln_calls() as (sigs_fwd, sigs_bwd), \
                record_fine_calls() as fine_calls:
            K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
            trainer = main(argv + ([] if cuda else ["--device", device]))
            launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
        with open(paths["val_txt"]) as f:
            n_val = len(json.load(f))
        with open(paths["train_ids"]) as f:
            n_train = len(json.load(f))

    rec, history = runs[0], list(trainer.history)
    model, state = trainer.state.model, trainer.state
    groups = spec.caption_groups
    if not scst["first_step_equal"] or not scst["restored"]:
        raise AssertionError("the SCST run did not start from the caption run's saved weights")
    if state.step != steps * len(groups) or len(history) != steps or state.optimizer.gradient_step != state.step:
        raise AssertionError(f"{len(history)} batches, state.step {state.step}, "
                             f"{state.optimizer.gradient_step} updates")
    keys = {f"{k}_{g}" for g in groups for k in ("scst_reward", "caption_loss")}
    if not all(set(h[2]) == keys and all(np.isfinite(v) for v in h[2].values()) for h in history):
        raise AssertionError(f"SCST metrics: {history}")
    end = model.state_dict()
    labels = dict(zip(state.optimizer.names, state.optimizer.labels))
    nonzero = dict(zip(state.optimizer.names, scst["nonzero"].tolist()))
    moved = {k: not torch_equal(end[k].detach().cpu(), v) for k, v in scst["restored"].items()}
    # every parameter of the fusion stack and head takes a gradient (the prompt
    # embedding only with prompts), the towers none; a parameter without one
    # moves only by weight decay.  How far a gradient moves its parameter
    # depends on the rewards, which random weights keep near zero: reported.
    fusion = [k for k in nonzero if k.split(".")[0] in ("multimodal_encoder", "cls_head")
              and (model.cfg.use_task_prompt or not k.endswith("prompt_embedding"))]
    no_grad = [k for k in fusion if not nonzero[k]]
    towers = [k for k in nonzero if nonzero[k] and k.split(".")[0] in ("clip_vision", "audio_encoder")]
    wrong = [k for k in nonzero if moved[k] and not nonzero[k] and not labels[k].endswith("_wd")]
    if no_grad or towers or wrong:
        raise AssertionError(f"fusion parameters without a gradient: {no_grad[:10]}; towers with one: "
                             f"{towers[:10]}; moved without a gradient or decay: {wrong[:10]}")
    if len(evals) != 1 or evals[0]["items"] != n_val:
        raise AssertionError(f"validations {[(e['kind'], e['items']) for e in evals]}, expected 1 of {n_val}")
    report = evals[0]["report"]
    if not all(k in report and np.isfinite(report[k]) for k in ("Bleu_4", "CIDEr", "METEOR", "ROUGE_L")):
        raise AssertionError(f"caption report {report}")
    per_fwd, per_bwd = expected_scst_ln_launches(model, spec)
    val_batches = -(-n_val // cfg.data_val[0].batch_size)
    expected = ((per_fwd * steps + val_batches * expected_ln_launches(model, model.cfg.use_task_prompt),
                 per_bwd * steps, 0) if cuda else (0, 0, 0))
    if launches != expected:
        raise AssertionError(f"launches (ln fwd, ln bwd, fine_score) {launches} != {expected}")

    step_s = np.diff([rec["start"]] + rec["stamps"])
    wait_s = np.diff([0.0] + rec["waits"])
    bounds = list(zip([rec["start"]] + rec["stamps"][:-1], rec["stamps"]))
    parts = {}
    for name in ("encode", "greedy_rollout", "sample_rollout", "host_reward", "update"):
        per_step = [sum(s for p, t0, s in scst["parts"] if p == name and lo <= t0 < hi) for lo, hi in bounds]
        parts[name] = float(np.median(per_step[2:]))
    timed = step_s[2:]  # the first two steps are warm-up
    median = float(np.median(timed))
    batch_size = cfg.data_train[0].batch_size
    rewards = [h[2][f"scst_reward_{groups[0]}"] for h in history]
    alpha = trainer.alpha
    summary = {
        "config": "configs/caption-msrvtt.json", "task": cfg.data_train[0].task, "batch": batch_size,
        "frames": cfg.data_train[0].video_sample_num, "clips": cfg.data_train[0].audio_sample_num,
        "max_len": cfg.model.max_generation_len, "beam_size": cfg.model.beam_size,
        "train_items": n_train, "val_items": n_val, "steps": steps, "median_step_s": median,
        "samples_per_s": batch_size / median, "step_s": [float(v) for v in step_s],
        "step_parts_median_s": parts, "step_other_s": median - sum(parts.values()),
        "data_wait_s": [float(v) for v in wait_s], "data_stall_share": float(wait_s[2:].sum() / timed.sum()),
        "device_idle_share": "not measured (no profiler trace in this phase)",
        "max_memory_allocated_gib": rec["peak"] / 2**30,
        "scst_reward": rewards, "mean_reward": float(np.mean(rewards)),
        "mean_greedy_reward": alpha.greedy_total / max(alpha.idx, 1), "alpha": alpha.value(),
        "alpha_type": alpha.alpha_type, "caption_loss": [h[2][f"caption_loss_{groups[0]}"] for h in history],
        "scorer_build_s": scst["scorer_build_s"], "restored_params_equal": scst["first_step_equal"],
        "params": len(moved), "params_moved": int(sum(moved.values())),
        "params_with_gradient": int(sum(nonzero.values())),
        "params_with_gradient_moved": int(sum(moved[k] for k in nonzero if nonzero[k])),
        "validation": {k: evals[0][k] for k in ("items", "seconds", "caption_eval_s", "meteor_lite_s")},
        "captions_per_s": evals[0]["items"] / evals[0]["seconds"], "report": report,
        "layernorm_launches_fwd_bwd": launches[:2], "fine_score_launches": launches[2],
        "ln_per_step_fwd_bwd": [per_fwd, per_bwd], "val_batches": val_batches,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
        "fine_score_calls": sorted({tuple(s_) for s_, _ in fine_calls}),
    }
    if synthetic:
        summary["caption_finetune_samples_per_s"] = synthetic["samples_per_s"]
    log("cli_scst " + json.dumps(summary))
    return summary


@contextlib.contextmanager
def record_batch_keys():
    """Yields a list that fills with the sorted keys of every batch that
    ``Trainer`` hands ``train_step``."""
    from valor_tpu_torch.train import trainer as T

    keys, step0 = [], T.train_step

    def step1(state, batch, *a, **kw):
        keys.append(sorted(batch))
        return step0(state, batch, *a, **kw)

    T.train_step = step1
    try:
        yield keys
    finally:
        T.train_step = step0


@contextlib.contextmanager
def record_pt_validations(sync):
    """Yields a list that fills with (items, seconds between two
    synchronisations, report) of every ``validate_pt`` call (a rank's items
    across processes)."""
    from valor_tpu_torch.eval import validate as V

    calls, fn0 = [], V.validate_pt

    def fn1(model, step_fn, loader, *a, **kw):
        counted = _Counted(loader)
        sync()
        t0 = time.perf_counter()
        report = fn0(model, step_fn, counted, *a, **kw)
        sync()
        calls.append((counted.items, time.perf_counter() - t0, report))
        return report

    V.validate_pt = fn1
    try:
        yield calls
    finally:
        V.validate_pt = fn0


@contextlib.contextmanager
def record_moe_routing():
    """Yields a list that fills with (module, kept choices, choices, kept
    choices of non-pad tokens, choices of non-pad tokens) of every
    training-mode MoE routing, the counts as device scalars (no
    synchronisation).  A token is pad where the fusion layer's padding term
    (its first bias term, [B, 1, 1, S]) masks it as a key."""
    from valor_tpu_torch.models import bert as B
    from valor_tpu_torch.ops import moe as M
    from valor_tpu_torch.ops.layers import NEG_INF

    calls, route0, layer0, valid = [], M.MoEMlpBlock.route, B.BertFusionLayer.forward, [None]

    def layer1(self, x, bias, *args, **kw):
        pad = bias[0] if isinstance(bias, (tuple, list)) else bias
        valid[0] = None if pad is None else (pad[:, 0, 0, :] > NEG_INF / 2)
        return layer0(self, x, bias, *args, **kw)

    def route1(self, x):
        r = route0(self, x)
        if self.training:
            v = valid[0]
            if v is None or tuple(v.shape) != tuple(x.shape[:2]):
                raise AssertionError(f"MoE input {tuple(x.shape)} without its padding term")
            v = v.to(r.keep.dtype)
            calls.append((self, r.keep.sum(), r.sel.sum(),
                          (r.keep.sum((0, 3)) * v).sum(), (r.sel.sum((0, 3)) * v).sum()))
        return r

    M.MoEMlpBlock.route, B.BertFusionLayer.forward = route1, layer1
    try:
        yield calls
    finally:
        M.MoEMlpBlock.route, B.BertFusionLayer.forward = route0, layer0


def first_pt_flow(raw: dict, paths: dict, out_dir: str, steps: int, batch_size: int, val_batch, prompts: bool,
                  overrides=None) -> None:
    """A pretraining config ``raw`` cut to its first train flow, pointed at
    phase 14's dataset (``paths``) at ``batch_size``, and with ``val_batch``
    one evaluation flow of the same task over its evaluation ids (none where
    None): ``steps`` steps, ``use_task_prompt`` set to ``prompts``."""
    flow = raw["data_cfg"]["train"][0]
    flow["datasets"][0].update(ids_path=paths["train_ids"], txt=paths["train_txt"],
                               video=paths["frames"], audio=paths["audio"])
    flow["batch_size"] = batch_size
    val = json.loads(json.dumps(flow))
    val["datasets"][0].update(ids_path=paths["val_ids"], txt=paths["val_txt"])
    val.update(batch_size=val_batch, epoch=1)
    raw["data_cfg"] = {"train": [flow], "val": [val] if val_batch else []}
    raw.update(output_dir=out_dir, num_train_steps=steps, valid_steps=0, first_eval=False,
               use_task_prompt=prompts, **(overrides or {}))


def phase_cli_pt_prompts(paths: dict, steps: int = 10, batch_size: int = 32, val_batch: int = 64,
                         device: str = "cuda", overrides=None, synthetic=None,
                         config: str = "pretrain-valor-base.json", prompts: bool = True,
                         label: str = "cli_pt_prompts"):
    """Pretraining from disk through ``cli.train``'s ``main``: the first train
    flow of ``configs/<config>`` (phase 18: ``pretrain-valor-base.json``,
    ``pt_contra%tva%tv%ta_caption%tva%tv%ta``, 4 frames, 1 clip, 40 tokens,
    ``video_transforms`` none) with ``use_task_prompt`` set to ``prompts``
    (on in phase 18: VALOR-large's setting, at VALOR-base width; phase b runs
    ``pretrain-valor-base-moe.json`` without, phase c
    ``pretrain-valor-large.json`` with), pointed at phase 14's dataset
    (``paths``), at ``batch_size``, and one evaluation flow of the same task
    over its evaluation ids (the config has none): ``steps`` steps, then
    ``validate_pt``.  Checks: the training batches carry the prompt arrays of
    the task (none without prompts), every loss finite, every report key
    present and finite, one fine-score launch a fine contrastive group, the
    LayerNorm launches those of the path.  With MoE layers it reports
    ``moe_aux`` a step over its weight (1 when balanced) and each layer's
    share of dropped choices, over all tokens and over non-pad tokens.
    ``overrides`` shrink the run for a CPU rehearsal."""
    import os

    import torch

    from valor_tpu_torch.cli.train import main
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data import native
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def edit(raw):
        first_pt_flow(raw, paths, os.path.join(tmp, "pt_out"), steps, batch_size, val_batch, prompts, overrides)

    with tempfile.TemporaryDirectory(prefix="valor_cli_pt_") as tmp, \
            cli_run(paths, tmp, config, edit) as cfg_path:
        cfg = load_config(cfg_path)
        spec = parse_task(cfg.data_train[0].task)
        with record_trainers(sync, cuda) as runs, record_pt_validations(sync) as evals, \
                record_batch_keys() as keys, record_ln_calls() as (sigs_fwd, sigs_bwd), \
                record_fine_calls() as fine_calls, record_moe_routing() as routing:
            with open("/proc/self/statm") as f:  # what earlier phases leave in this process
                rss0 = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30
            threads0, tmp_used0 = sorted(t.name for t in threading.enumerate()), shutil.disk_usage(tmp).used / 2**30
            K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
            calls0 = native.CALLS
            trainer = main(["--config", cfg_path] + ([] if cuda else ["--device", device]))
            launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
            native_calls = native.CALLS - calls0
        with open(paths["val_ids"]) as f:
            n_val = len(json.load(f))
    # transforms "none": every item decodes through the C++ decoder where it builds, else with PIL
    if native.available() and native_calls < steps * batch_size + n_val:
        raise AssertionError(f"{native_calls} native decodes for {steps * batch_size + n_val} items or more: "
                             "a transforms-none path decoded with PIL")
    if not native.available() and native_calls:
        raise AssertionError(f"{native_calls} native decodes, but the decoder did not build")

    rec, history = runs[0], list(trainer.history)
    model = trainer.state.model
    prompt_keys = (({"prompt_tokens_contra"} if spec.contra_groups else set()) |
                   ({"prompt_tokens_caption"} if spec.caption_groups else set()) |
                   {f"prompt_tokens_mlm_{g}" for g in spec.mlm_groups}) if prompts else set()
    if len(keys) != steps or any({k for k in ks if k.startswith("prompt_tokens")} != prompt_keys for ks in keys):
        raise AssertionError(f"training batches' prompt keys {[k for k in keys[0] if 'prompt' in k]}, "
                             f"expected {sorted(prompt_keys)}")
    if len(history) != steps or not all(np.isfinite(v) for h in history for v in h[2].values()):
        raise AssertionError(f"{len(history)} steps logged, or a non-finite loss: {history}")
    if len(evals) != 1 or evals[0][0] != n_val:
        raise AssertionError(f"validate_pt calls (items) {[e[0] for e in evals]}, expected 1 of {n_val}")
    report = evals[0][2]
    want = ({f"caption_acc_{g}" for g in spec.caption_groups} | {f"mlm_acc_{g}" for g in spec.mlm_groups}
            | {f"contra_recall_{g}" for g in spec.contra_groups}
            | ({"caption_token_acc"} if spec.caption_groups else set())
            | ({"mlm_token_acc"} if spec.mlm_groups else set()))
    if set(report) != want or not all(np.isfinite(v) for v in report.values()):
        raise AssertionError(f"validate_pt report {report}, expected the keys {sorted(want)}")
    per_step = expected_train_ln_launches(model, spec)
    val_batches = -(-n_val // val_batch)
    fine_groups = spec.contra_groups if cfg.model.contra_type == "fine" else ()
    expected = ((per_step * (steps + val_batches), per_step * steps, len(fine_groups)) if cuda else (0, 0, 0))
    if launches != expected:
        raise AssertionError(f"launches (ln fwd, ln bwd, fine_score) {launches} != {expected}")

    step_s = np.diff([rec["start"]] + rec["stamps"])
    wait_s = np.diff([0.0] + rec["waits"])
    timed = step_s[2:]
    median = float(np.median(timed))
    summary = {
        "config": f"configs/{config} (first train flow)", "task": spec.raw, "batch": batch_size,
        "frames": cfg.data_train[0].video_sample_num, "clips": cfg.data_train[0].audio_sample_num,
        "max_txt_len": cfg.data_train[0].max_txt_len, "video_transforms": cfg.data_train[0].datasets[0].video_transforms,
        "use_task_prompt": cfg.model.use_task_prompt, "val_items": n_val, "val_batch": val_batch,
        "decoder": "native" if native.available() else "PIL (the C++ decoder did not build)",
        "native_calls": native_calls, "rss_at_start_gib": rss0, "threads_at_start": threads0,
        "tmp_used_at_start_gib": tmp_used0, "steps": steps, "median_step_s": median, "samples_per_s": batch_size / median,
        "step_s": [float(v) for v in step_s], "data_wait_s": [float(v) for v in wait_s],
        "data_stall_share": float(wait_s[2:].sum() / timed.sum()),
        "device_idle_share": "not measured (no profiler trace in this phase)",
        "max_memory_allocated_gib": rec["peak"] / 2**30,
        "losses": {k: [h[2][k] for h in history] for k in history[0][2]},
        "prompt_keys": sorted(prompt_keys),
        "validate_pt_s": evals[0][1], "validate_pt_items_per_s": n_val / evals[0][1], "report": report,
        "layernorm_launches_fwd_bwd": launches[:2], "fine_score_launches": launches[2],
        "ln_per_step": per_step, "val_batches": val_batches,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
        "fine_score_calls": sorted({tuple(s_) for s_, _ in fine_calls}),
    }
    if synthetic:
        summary["in_memory_samples_per_s"] = synthetic["samples_per_s"]
        summary["disk_over_in_memory"] = summary["samples_per_s"] / synthetic["samples_per_s"]
    if cfg.model.fusion_moe_experts:
        from valor_tpu_torch.ops.moe import MoEMlpBlock

        names = {m: n for n, m in model.named_modules() if isinstance(m, MoEMlpBlock)}
        kept, chosen, kept_tok, chosen_tok = {}, {}, {}, {}
        for mod, k, n, kt, nt in routing:
            for acc, val in ((kept, k), (chosen, n), (kept_tok, kt), (chosen_tok, nt)):
                acc[names[mod]] = acc.get(names[mod], 0.0) + float(val)
        if sorted(kept) != sorted(names.values()):
            raise AssertionError(f"MoE layers routed {sorted(kept)}, built {sorted(names.values())}")
        summary["moe_aux_over_weight"] = [h[2]["moe_aux"] / cfg.model.fusion_moe_aux_weight for h in history]
        summary["moe_dropped_share"] = {n: 1.0 - kept[n] / chosen[n] for n in sorted(kept)}
        summary["moe_dropped_share_non_pad"] = {n: 1.0 - kept_tok[n] / chosen_tok[n] for n in sorted(kept)}
        summary["moe_non_pad_share"] = {n: chosen_tok[n] / chosen[n] for n in sorted(kept)}
        summary["moe"] = {"experts": cfg.model.fusion_moe_experts, "top_k": cfg.model.fusion_moe_top_k,
                          "every": cfg.model.fusion_moe_every,
                          "capacity_factor": cfg.model.fusion_moe_capacity_factor}
    log(f"{label} " + json.dumps(summary))
    return summary


# -- phases 19-22: video in and weights in --------------------------------------
@contextlib.contextmanager
def pil_decoding():
    """Inside the block ``VideoMapper`` decodes with PIL, as without the C++ decoder."""
    from valor_tpu_torch.data import native

    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def phase_decoder(paths, n_frames: int = 8, resolution: int = 224, threads: int = 8):
    """The C++ decoder (``data/native.py``, built from
    ``csrc/host/valor_native.cpp``) against the PIL route on phase 14's
    evaluation ids (``paths``): whether it built (the compiler's message if
    not), frames/s of ``VideoMapper(transforms="none", output_uint8=True)`` at
    ``resolution`` through each decoder, single-threaded and from ``threads``
    loader threads, and the two decoders' agreement (correlation per item
    above 0.98, ``tests/test_native.py``'s bar; largest difference and share
    of pixels that differ)."""
    from valor_tpu_torch.data import native
    from valor_tpu_torch.data.pipeline import VideoMapper

    with open(paths["val_ids"]) as f:
        ids = json.load(f)
    mapper = VideoMapper(paths["frames"], resolution, sample_num=n_frames, transforms="none",
                         training=False, output_uint8=True)
    built = native.available()

    def run(n_threads):
        t0 = time.perf_counter()
        if n_threads == 1:
            outs = [mapper[i] for i in ids]
        else:
            with ThreadPoolExecutor(n_threads) as pool:
                outs = list(pool.map(mapper.__getitem__, ids))
        dt = time.perf_counter() - t0
        if any(o is None or o.shape != (n_frames, resolution, resolution, 3) for o in outs):
            raise AssertionError("a frame did not decode")
        return len(ids) * n_frames / dt, outs

    summary = {"native_built": built, "build_error": native.BUILD_ERROR, "items": len(ids),
               "frames": len(ids) * n_frames, "resolution": resolution, "threads": threads}
    with pil_decoding():
        summary["pil_frames_per_s_1_thread"], pil = run(1)
        summary["pil_frames_per_s_threads"], _ = run(threads)
    if built:
        calls = native.CALLS
        summary["native_frames_per_s_1_thread"], nat = run(1)
        summary["native_frames_per_s_threads"], _ = run(threads)
        if native.CALLS - calls != 2 * len(ids):
            raise AssertionError(f"{native.CALLS - calls} native calls for {2 * len(ids)} items")
        corr, diff_max, differ = [], 0, 0
        for a, b in zip(nat, pil):
            a, b = a.astype(np.float32).ravel(), b.astype(np.float32).ravel()
            corr.append(float(np.corrcoef(a, b)[0, 1]))
            diff_max = max(diff_max, int(np.abs(a - b).max()))
            differ += int((a != b).sum())
        summary.update(corr_min=min(corr), corr_mean=float(np.mean(corr)), max_abs_diff_u8=diff_max,
                       share_of_values_that_differ=differ / (len(ids) * n_frames * resolution ** 2 * 3))
        if min(corr) <= 0.98:
            raise AssertionError(f"native against PIL: correlation {min(corr)} <= 0.98")
        summary["native_over_pil_threads"] = summary["native_frames_per_s_threads"] / summary[
            "pil_frames_per_s_threads"]
    else:
        summary["native_frames_per_s_1_thread"] = summary["native_frames_per_s_threads"] = "not built"
    log(("decoder: built" if built else f"decoder: not built, frames decode with PIL: {native.BUILD_ERROR}"))
    log("decoder " + json.dumps(summary))
    return summary


@contextlib.contextmanager
def ffmpeg_on_path(bin_dir: str):
    """Yields (the ffmpeg that ``PATH`` finds or "", a line that says which):
    a real ffmpeg where there is one, else ``data/synthetic.py``'s stand-in,
    put at the front of ``PATH`` for the block."""
    import os

    from valor_tpu_torch.data.synthetic import write_ffmpeg_stand_in

    real = shutil.which("ffmpeg") or ""
    path0 = os.environ["PATH"]
    if real:
        version = subprocess.run([real, "-version"], capture_output=True, text=True).stdout.splitlines()
        line = f"ffmpeg: {version[0] if version else real}"
    else:
        os.environ["PATH"] = f"{os.path.dirname(write_ffmpeg_stand_in(bin_dir))}{os.pathsep}{path0}"
        line = "ffmpeg: stand-in"
    log(line)
    try:
        yield real, line
    finally:
        os.environ["PATH"] = path0


@contextlib.contextmanager
def record_models():
    """Yields a list that fills with every model ``models/bridge.py:load_model``
    builds inside the block."""
    from valor_tpu_torch.models import bridge

    models, fn0 = [], bridge.load_model

    def fn1(*a, **kw):
        models.append(fn0(*a, **kw))
        return models[-1]

    bridge.load_model = fn1
    try:
        yield models
    finally:
        bridge.load_model = fn0


def check_restored(model, run_dir: str) -> int:
    """Every parameter of ``model`` equals the latest checkpoint's of
    ``run_dir`` (in the model's type); returns how many were compared."""
    import torch

    from valor_tpu_torch.cli.train import restore_weights

    saved = restore_weights(run_dir)["params"]
    sd = model.state_dict()
    if set(sd) != set(saved):
        raise AssertionError(f"restored keys differ: {sorted(set(sd) ^ set(saved))[:5]}")
    for k, v in sd.items():
        if not torch.equal(v.cpu(), saved[k].to(v.dtype)):
            raise AssertionError(f"{k} differs from the checkpoint of {run_dir}")
    return len(sd)


def phase_extract_infer(cap_paths: dict, cap_run: str, n_clips: int = 4, seconds: float = 10.0,
                        clip_size=(320, 240), device: str = "cuda", overrides=None, root=None):
    """``cli.extract``, then ``cli.infer`` at the full width of
    ``configs/caption-msrvtt.json`` with ``--checkpoint`` phase 15's caption run
    (``cap_run``; its vocabulary and merges in ``cap_paths``): ``n_clips``
    synthetic clips of ``seconds`` s of ``clip_size`` frames at 4 fps with a
    tone (encoded by ffmpeg where there is one, else in the stand-in's
    container), extracted by ``python -m valor_tpu_torch.cli.extract`` (the
    layout read back through ``VideoMapper`` and ``AudioMapper`` as
    ``cli.train`` reads it), then ``cli.infer``'s ``main`` on the first clip at
    beam 3 and with a question for ``qa%tva``.  Checks: the restored weights
    equal the run's, each caption equals an in-process ``Generator.generate``
    on the same pixels and weights, the LayerNorm launches those of one
    decode, no fine-score launch.  ``overrides`` shrink the model for a CPU
    rehearsal; with ``root`` the clips stay there for phase 21."""
    import io

    import torch

    from valor_tpu_torch.cli import infer
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.data.pipeline import AudioMapper, VideoMapper
    from valor_tpu_torch.data.synthetic import write_video_clip
    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    cuda = device == "cuda"
    dev_args = [] if cuda else ["--device", device]

    def edit(raw):
        raw.update(**(overrides or {}))

    with (contextlib.nullcontext(root) if root else tempfile.TemporaryDirectory(prefix="valor_infer_")) as tmp, \
            ffmpeg_on_path(os.path.join(tmp, "bin")) as (ffmpeg, ffmpeg_line), \
            tempfile.TemporaryDirectory(prefix="valor_infer_cfg_") as cfg_tmp, \
            cli_run(cap_paths, cfg_tmp, "caption-msrvtt.json", edit) as cfg_path:
        cfg = load_config(cfg_path).model
        clips_dir = os.path.join(tmp, "clips")
        os.makedirs(clips_dir, exist_ok=True)
        t0 = time.perf_counter()
        clips = [write_video_clip(os.path.join(clips_dir, f"clip{i}.mp4"), seconds, clip_size, fps=4,
                                  tone_hz=220.0 * (i + 1), seed=10 + i, ffmpeg=ffmpeg) for i in range(n_clips)]
        clips_s = time.perf_counter() - t0
        ext = os.path.join(tmp, "extracted")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "valor_tpu_torch.cli.extract", "--video_dir", clips_dir,
                        "--out_dir", ext, "--fps", "4", "--workers", str(n_clips)], check=True, cwd=str(ROOT))
        extract_s = time.perf_counter() - t0
        ids = sorted(os.listdir(os.path.join(ext, "frames_fps4")))
        if ids != [f"clip{i}" for i in range(n_clips)]:
            raise AssertionError(f"cli.extract wrote {ids}")
        frames_per_clip = [len(os.listdir(os.path.join(ext, "frames_fps4", v))) for v in ids]
        vm = VideoMapper(os.path.join(ext, "frames_fps4"), cfg.video_resolution, sample_num=4,
                         transforms="crop_flip", training=True, output_uint8=True)
        am = AudioMapper(os.path.join(ext, "audio_22050hz"), sample_num=1, melbins=cfg.audio_melbins,
                         target_length=cfg.audio_target_length, training=True, device_fbank=True)
        for v in ids:
            if vm[v] is None or vm[v].shape != (4, cfg.video_resolution, cfg.video_resolution, 3) \
                    or not (am[v]["valid_frames"] > 0).all():
                raise AssertionError(f"the extracted layout of {v} does not read back")

        runs = {}
        with record_models() as models, record_ln_calls() as (sigs, _):
            for name, argv in (("caption", ["--beam_size", "3"]),
                               ("question", ["--task", "qa%tva", "--question", "what is the man playing",
                                             "--beam_size", "1"])):
                out = io.StringIO()
                K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
                with contextlib.redirect_stdout(out):
                    result = infer.main(["--video_path", clips[0], "--config", cfg_path, "--checkpoint", cap_run,
                                         *argv, *dev_args])
                launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
                runs[name] = dict(result, printed=out.getvalue().splitlines(), launches=launches)
                log(f"cli.infer {name}: {runs[name]['printed']}")
        for (name, run), model in zip(runs.items(), models):
            expected = (expected_ln_launches(model, prompt=name == "question"), 0, 0) if cuda else (0, 0, 0)
            if run["launches"] != expected:
                raise AssertionError(f"cli.infer {name}: launches {run['launches']} != {expected}")
            run["parameters_checked"] = check_restored(model, cap_run)
            beam = 3 if name == "caption" else 1
            groups = tuple(run["sequences"])
            direct = Generator(model).generate(run["batch"], groups, caption_type=cfg.caption_type,
                                               max_len=cfg.max_generation_len, beam_size=beam)
            for g in groups:
                if not np.array_equal(direct[f"generated_sequences_{g}"][0].cpu().numpy(), run["sequences"][g]):
                    raise AssertionError(f"cli.infer {name} [{g}] differs from the in-process Generator")
            if run["printed"] != [f"[{g}] {run['captions'][g]}" for g in groups]:
                raise AssertionError(f"cli.infer {name} printed {run['printed']}")
        del models[:]
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    summary = {
        "config": "configs/caption-msrvtt.json", "checkpoint": "phase 15's caption run", "ffmpeg": ffmpeg_line,
        "clips": n_clips, "clip_seconds": seconds, "clip_size": list(clip_size), "clips_written_s": clips_s,
        "cli_extract_s": extract_s, "frames_per_clip": frames_per_clip,
        "infer": {name: {"seconds": r["seconds"], "captions": r["captions"], "printed": r["printed"],
                         "layernorm_launches_fwd_bwd": list(r["launches"][:2]),
                         "fine_score_launches": r["launches"][2], "parameters_checked": r["parameters_checked"],
                         "video_pixels": list(r["batch"]["video_pixels"].shape),
                         "audio_spectrograms": list(r["batch"]["audio_spectrograms"].shape)}
                  for name, r in runs.items()},
        "layernorm_launches_fwd_bwd": [sum(r["launches"][0] for r in runs.values()), 0],
        "fine_score_launches": 0, "layernorm_calls": sorted(sigs),
        "clip_paths": clips,
    }
    log("extract_infer " + json.dumps({k: v for k, v in summary.items() if k != "layernorm_calls"}))
    return summary


def phase_serve_video(cap_paths: dict, cap_run: str, clips, n_requests: int = 16, bucket: int = 16,
                      device: str = "cuda", overrides=None):
    """``cli/serve.py``'s ``serve`` in this process (as phase 5 serves) at the
    full width of ``configs/caption-valor32k.json`` with ``--checkpoint``
    phase 15's caption run, bucket ``bucket``, and the ``video_path``
    featurizer at 8 frames and 2 clips: a warm-up request a clip, then a
    burst of ``n_requests`` ``video_path`` requests from as many threads over
    ``clips`` (phase 20's), then two with questions, and one for a missing
    video (a 400).  Checks: every status 200, each served caption equal to an
    in-process ``Generator.generate`` of its item at its bucket size with the
    run's weights (the served row's tokens, and the reply's text its decode),
    the LayerNorm launches those of the batches served.  It
    prints latency p50 and p95 at the client (featurizing included),
    captions/s and the featurizer's share of a request."""
    import urllib.error
    import urllib.request

    import torch

    from valor_tpu_torch.cli import serve as S
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.eval.validate import decode_sequence
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    from valor_tpu_torch.cli import infer

    cuda = device == "cuda"
    featurized, ffmpeg_s = [], []  # (payload, item, seconds); seconds in ffmpeg
    fz0, ex0 = S.production_featurizer, infer.extract_frames_and_wav

    def timed_extract(*a, **kw):
        t0 = time.perf_counter()
        ex0(*a, **kw)
        ffmpeg_s.append(time.perf_counter() - t0)

    def timed_featurizer(*a, **kw):
        fn = fz0(*a, **kw)

        def featurize(payload):
            t0 = time.perf_counter()
            item = fn(payload)
            featurized.append((payload, item, time.perf_counter() - t0))
            return item

        return featurize

    def edit(raw):
        raw.update(**(overrides or {}))

    with tempfile.TemporaryDirectory(prefix="valor_serve_video_") as tmp, \
            ffmpeg_on_path(os.path.join(tmp, "bin")) as (_, ffmpeg_line), \
            cli_run(cap_paths, tmp, "caption-valor32k.json", edit) as cfg_path:
        vocab0, S.DEFAULT_BERT_VOCAB = S.DEFAULT_BERT_VOCAB, cap_paths["vocab"]  # read at import, as $VALOR_BERT_VOCAB
        S.production_featurizer, infer.extract_frames_and_wav = timed_featurizer, timed_extract
        try:
            t0 = time.perf_counter()
            server, engine = S.serve(["--config", cfg_path, "--checkpoint", cap_run, "--port", "0",
                                      "--bucket", str(bucket), "--max_wait_ms", "50",
                                      *([] if cuda else ["--device", device])])
            build_s = time.perf_counter() - t0
        finally:
            S.production_featurizer, S.DEFAULT_BERT_VOCAB = fz0, vocab0
            infer.extract_frames_and_wav = ex0
        submitted, submit0 = [], engine.submit

        def submit(item, **kw):  # the served rows, beside the texts the HTTP replies carry
            fut = submit0(item, **kw)
            submitted.append((item, fut))
            return fut

        engine.submit = submit
        tok = BertTokenizer(cap_paths["vocab"])
        base = "http://%s:%d" % server.server_address

        def post(payload):
            req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode())
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    code, out = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                code, out = e.code, json.loads(e.read())
            return code, out, time.perf_counter() - t0

        try:
            params_checked = check_restored(engine.model, cap_run)
            with ThreadPoolExecutor(len(clips)) as pool:  # warm-up: one request a clip
                warm = list(pool.map(lambda c: post({"video_path": c}), clips))
            if any(c != 200 for c, _, _ in warm):
                raise AssertionError(f"warm-up: {[(c, o) for c, o, _ in warm]}")
            featurized.clear()
            ffmpeg_s.clear()
            submitted.clear()
            engine.reset_stats()
            payloads = [{"video_path": clips[j % len(clips)]} for j in range(n_requests)]
            questions = [{"video_path": clips[0], "question": "what is the man playing"},
                         {"video_path": clips[1], "question": "who is on the grass"}]
            with record_ln_calls() as (sigs, _):
                K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
                t0 = time.perf_counter()
                with ThreadPoolExecutor(n_requests) as pool:
                    burst = list(pool.map(post, payloads))
                wall = time.perf_counter() - t0
                video_batches = engine.stats()["batches"]
                with ThreadPoolExecutor(2) as pool:
                    asked = list(pool.map(post, questions))
                launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
            stats = engine.stats()
            missing = post({"video_path": os.path.join(tmp, "missing.mp4")})
            if missing[0] != 400:
                raise AssertionError(f"a missing video: expected 400, got {missing[:2]}")
            codes = [c for c, _, _ in burst + asked]
            if any(c != 200 for c in codes):
                raise AssertionError(f"status codes {codes}: {[o for c, o, _ in burst + asked if c != 200]}")
            per_batch = expected_ln_launches(engine.model)
            per_q = expected_ln_launches(engine.model, prompt=True)
            q_batches = stats["batches"] - video_batches
            expected = (video_batches * per_batch + q_batches * per_q, 0, 0) if cuda else (0, 0, 0)
            if launches != expected:
                raise AssertionError(f"serving launches {launches} != {expected} "
                                     f"({video_batches} + {q_batches} batches)")
            keys = {id(item): (payload["video_path"], payload.get("question")) for payload, item, _ in featurized}
            gen, refs, L = Generator(engine.model), {}, engine.cfg.max_len
            for item, fut in submitted[:len(payloads) + len(questions)]:
                row = fut.result(timeout=0)
                key = (*keys[id(item)], row["bucket"])
                if key not in refs:  # the item alone at its bucket size: rows do not mix in the decode
                    batch = {k: np.stack([v] * row["bucket"]) for k, v in item.items()}
                    if engine.prompts:
                        batch["prompt_tokens_caption"] = engine.prompts[engine.cfg.group]
                    refs[key] = gen.generate(batch, (engine.cfg.group,), caption_type=engine.cfg.caption_type,
                                             max_len=L)[f"generated_sequences_{engine.cfg.group}"][0].cpu().numpy()
                if not np.array_equal(row["sequences"], refs[key]):
                    raise AssertionError(f"served {row['sequences']} != in-process {refs[key]} for {key}")
            want = sorted(decode_sequence(tok, refs[(*keys[id(i)], f.result(timeout=0)["bucket"])])
                          for i, f in submitted[:len(payloads) + len(questions)])
            if sorted(o["text"] for _, o, _ in burst + asked) != want:
                raise AssertionError("the HTTP replies' texts are not the served rows' decodes")
        finally:
            server.shutdown()
            server.server_close()
            engine.shutdown()
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    lat = np.asarray([s_ for _, _, s_ in burst])
    feat = [s_ for p, _, s_ in featurized if "question" not in p]
    summary = {
        "config": "configs/caption-valor32k.json", "checkpoint": "phase 15's caption run", "ffmpeg": ffmpeg_line,
        "bucket": bucket, "frames": 8, "clips": 2, "requests": n_requests, "questions": len(questions),
        "server_build_s": build_s, "parameters_checked": params_checked,
        "status_codes": sorted(set(codes)), "missing_video": missing[0],
        "latency_p50_s": float(np.percentile(lat, 50)), "latency_p95_s": float(np.percentile(lat, 95)),
        "captions_per_s": n_requests / wall, "burst_wall_s": wall,
        "featurize_mean_s": float(np.mean(feat)), "featurize_share": float(np.mean(feat) / lat.mean()),
        "ffmpeg_mean_s": float(np.mean(ffmpeg_s)), "ffmpeg_share": float(np.mean(ffmpeg_s) / lat.mean()),
        "batches": stats["batches"], "video_batches": video_batches, "engine_latency_p50_s": stats["latency_p50_s"],
        "buckets": sorted({o["bucket"] for _, o, _ in burst + asked}), "rows_checked": len(burst + asked),
        "distinct_references": len(refs), "texts": sorted({o["text"][:60] for _, o, _ in burst + asked}),
        "layernorm_launches": launches[0], "fine_score_launches": launches[2],
        "ln_per_batch": per_batch, "ln_per_question_batch": per_q, "layernorm_calls": sorted(sigs),
    }
    log("serve_video " + json.dumps({k: v for k, v in summary.items() if k != "layernorm_calls"}))
    return summary


CONVERT_CHILD = """
import json, resource, sys, time
from valor_tpu_torch.cli.build import convert_public
from valor_tpu_torch.core.config import load_config
from valor_tpu_torch.models.convert import load_converted
cfg_path, kind, path = sys.argv[1:]
mcfg = load_config(cfg_path).model
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
t0 = time.perf_counter()
if kind == "valor":
    load_converted(path, resolution=mcfg.video_resolution)
else:
    convert_public(kind, path, mcfg)
seconds = time.perf_counter() - t0
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"call": kind, "seconds": seconds, "peak_rss_gib": peak / 2**20, "rss_before_gib": before / 2**20}))
"""
# a process started by this one inherits its peak resident size (ru_maxrss) through the exec; one
# started by a small launcher does not
LAUNCHER = "import subprocess, sys; sys.exit(subprocess.run([sys.executable, *sys.argv[1:]]).returncode)"


def conversion_cost(cfg_path: str, kind: str, path: str) -> dict:
    """Seconds and peak resident size (``ru_maxrss``) of one conversion, each
    in a fresh process that only imports the port and converts, started
    through ``LAUNCHER``: the conversion of ``cli/build.py:convert_public``, or
    ``load_converted`` for ``kind`` "valor", as ``cli.train`` calls them."""
    out = subprocess.run([sys.executable, "-c", LAUNCHER, "-c", CONVERT_CHILD, cfg_path, kind, path],
                         cwd=str(ROOT), capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"converting {kind} ({path}) failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_layout(sources, converted, restored, ast_grid=None) -> dict:
    """Every converted tensor (``converted``: a ``state_dict`` that the port's
    converters gave) is in the restored model (``restored``) bit for bit, and
    comes from its source file (``sources``: the files' state dicts, as
    tensors): it equals a source tensor, or a third of one (the q/k/v split of
    an ``in_proj``/``qkv``), or is the AST position embedding resized from the
    12 x 101 grid to ``ast_grid``.  Returns the counts of each kind."""
    import torch

    from valor_tpu_torch.train.checkpoints import bilinear_resize_pos_embed_2d

    def fp(t):
        flat = t.reshape(-1)
        return tuple(t.shape), tuple(flat[:4].tolist()), float(flat.double().sum())

    index = {}
    for sd in sources:
        for k, t in sd.items():
            t = t.detach().float()
            index.setdefault(fp(t), []).append(t)
            if ("in_proj" in k or "qkv" in k) and t.shape[0] % 3 == 0:
                for part in t.chunk(3, 0):
                    index.setdefault(fp(part), []).append(part)
    ast_pos = [sd[n][0].float().numpy() for sd in sources for n in sd if n.endswith("v.pos_embed")]
    counts = {"converted": len(converted), "equal_to_a_source_tensor": 0, "resized": 0}
    for k, t in converted.items():
        if k not in restored or not torch.equal(restored[k].detach().float().cpu(), t):
            raise AssertionError(f"{k}: the restored model does not hold the converted tensor")
        if any(torch.equal(t, s) for s in index.get(fp(t), [])):
            counts["equal_to_a_source_tensor"] += 1
        elif k.endswith("position_embeddings") and ast_pos and np.array_equal(t.numpy(), bilinear_resize_pos_embed_2d(
                np.concatenate([ast_pos[0][:1], ast_pos[0][2:]]), (12, 101), ast_grid, has_cls=True)):
            counts["resized"] += 1
        else:
            raise AssertionError(f"{k}: no source tensor gives it")
    return counts


def phase_weights_in(cap_paths: dict, steps: int = 5, device: str = "cuda", overrides=None, seed: int = 0):
    """Weights in at the full width of ``configs/caption-msrvtt.json``:
    synthetic files in the released layouts (``data/synthetic.py``: a CLIP
    ViT-B/16 JIT archive, a BERT-base ``.bin``, an AudioSet AST checkpoint and
    a whole VALOR ``.pt``; random values under the real names and shapes),
    then ``cli.train`` on phase 15's caption dataset for ``steps`` steps twice:
    with ``$VALOR_PRETRAINED_DIR`` at the three encoder files, and with
    ``--checkpoint`` the ``.pt``.  Checks, per run: every converted tensor is
    in the model after the restore and comes from its source
    (``check_layout``, all of them), the first loss finite, the LayerNorm
    launches those of the path.  It prints each conversion's seconds and peak
    resident size, each taken in a fresh process (``conversion_cost``)."""
    import torch

    from valor_tpu_torch.cli import build as B
    from valor_tpu_torch.cli import train as T
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import write_released_checkpoints
    from valor_tpu_torch.models import convert as C
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    with tempfile.TemporaryDirectory(prefix="valor_weights_") as tmp:
        pdir = os.path.join(tmp, "pretrained")

        def edit(raw):
            point_at(raw, cap_paths)
            raw["data_cfg"]["val"] = []
            raw.update(output_dir=os.path.join(tmp, "out"), num_train_steps=steps, valid_steps=0,
                       first_eval=False, **(overrides or {}))

        with cli_run(cap_paths, tmp, "caption-msrvtt.json", edit) as cfg_path:
            cfg = load_config(cfg_path)
            spec = parse_task(cfg.data_train[0].task)
            t0 = time.perf_counter()
            files = write_released_checkpoints(pdir, cfg.model, seed)
            out["files_written_s"] = time.perf_counter() - t0
            out["file_bytes"] = {k: os.path.getsize(p) for k, p in files.items()}
            for run, argv in (("encoders", []), ("valor_pt", ["--checkpoint", files["valor"]])):
                captured = []
                adapted0, init0 = T._adapted, B.initialize_encoder_weights

                def adapted1(state, params):
                    sd = adapted0(state, params)
                    captured.append({k: v.detach().cpu().clone() for k, v in sd.items()})
                    return sd

                def init1(mcfg, state_dict):
                    sd = init0(mcfg, state_dict)
                    captured.append({k: v.detach().cpu().clone() for k, v in sd.items()})
                    return sd

                T._adapted, B.initialize_encoder_weights = adapted1, init1
                if run == "encoders":
                    os.environ["VALOR_PRETRAINED_DIR"] = pdir
                    found = [k for k, _ in B.public_weight_files(cfg.model)]
                    if cuda and found != ["clip", "ast", "bert"]:  # VALOR-base finds all three files
                        raise AssertionError(f"cli.train finds {found} of clip, ast and bert")
                try:
                    with record_trainers(sync, cuda) as runs, record_ln_calls() as (sigs_fwd, sigs_bwd):
                        K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
                        trainer = T.main(["--config", cfg_path, "--output_dir", os.path.join(tmp, f"out_{run}"),
                                          *argv, *([] if cuda else ["--device", device])])
                        launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
                finally:
                    T._adapted, B.initialize_encoder_weights = adapted0, init0
                    os.environ["VALOR_PRETRAINED_DIR"] = os.path.join(tmp, "no_public_weights")
                restored = captured[-1]  # after the encoder lookup, and after the --checkpoint load
                if run == "encoders":
                    sources = [C._load_torch(files[k]) for k in found]
                    converted = {}
                    for k, sd in zip(found, sources):
                        converted.update(B.converted_state_dict(B.convert_public(k, sd, cfg.model)))
                else:
                    sources = [C._load_torch(files["valor"])]
                    converted = B.converted_state_dict(C.convert_valor_full(sources[0], cfg.model.video_resolution))
                m = cfg.model
                dropped = sorted(set(converted) - set(restored))  # adapted away: the model has no such tensor
                if cuda and dropped:
                    raise AssertionError(f"{run}: converted tensors the VALOR-base model lacks: {dropped[:5]}")
                converted = {k: v for k, v in converted.items() if k not in dropped}
                layout = check_layout([{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()} for s in sources],
                                      converted, restored, (m.audio_melbins // m.audio_patch_size,
                                                            m.audio_target_length // m.audio_patch_size))
                del sources, converted, captured
                history = list(trainer.history)
                first = history[0][2]
                if len(history) != steps or not all(np.isfinite(v) for v in first.values()):
                    raise AssertionError(f"{run}: {len(history)} steps, first losses {first}")
                per_step = expected_train_ln_launches(trainer.state.model, spec)
                expected = (per_step * steps, per_step * steps, 0) if cuda else (0, 0, 0)
                if launches != expected:
                    raise AssertionError(f"{run}: launches (ln fwd, ln bwd, fine_score) {launches} != {expected}")
                rec = runs[0]
                step_s = np.diff([rec["start"]] + rec["stamps"])
                out[run] = {
                    "conversions": [conversion_cost(cfg_path, k, files[k])
                                    for k in (found if run == "encoders" else ["valor"])],
                    "converted_tensors": layout, "not_in_model": len(dropped), "model_tensors": len(restored),
                    "first_losses": first, "losses": [h[2][next(iter(first))] for h in history],
                    "step_s": [float(v) for v in step_s], "max_memory_allocated_gib": rec["peak"] / 2**30,
                    "layernorm_launches_fwd_bwd": list(launches[:2]), "fine_score_launches": launches[2],
                    "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
                }
                del trainer, runs, restored
                gc.collect()
                if cuda:
                    torch.cuda.empty_cache()
    summary = dict(out, config="configs/caption-msrvtt.json", task=spec.raw, steps=steps,
                   layernorm_launches_fwd_bwd=[sum(out[r]["layernorm_launches_fwd_bwd"][i]
                                                   for r in ("encoders", "valor_pt")) for i in (0, 1)],
                   fine_score_launches=0,
                   layernorm_calls=sorted({tuple(s) for r in ("encoders", "valor_pt")
                                           for s in out[r]["layernorm_calls"]}),
                   layernorm_bwd_calls=sorted({tuple(s) for r in ("encoders", "valor_pt")
                                               for s in out[r]["layernorm_bwd_calls"]}))
    log("weights_in " + json.dumps({k: ({kk: vv for kk, vv in v.items() if "calls" not in kk}
                                        if isinstance(v, dict) else v)
                                    for k, v in summary.items() if "calls" not in k}))
    return summary


# -- phases a-e: MoE fusion, grouped-query cross-attention, VideoSwin, VALOR-large, 392 px MSCOCO --
FAMILIES = {  # phase a's tiny variants
    "moe": {"fusion_moe_experts": 4, "fusion_moe_every": 2},
    "gqa": {"fusion_cross_attn_kv_heads": 1},
    "videoswin": {"video_encoder_type": "videoswin_tiny_test", "txt_encoder_type": "bert_base_uncased",
                  "init_clip_head": False},
}
SWIN_CAPTION = {"video_encoder_type": "videoswin_base_k600_22k", "txt_encoder_type": "bert_base_uncased"}


def phase_families_card_vs_cpu(device: str = "cuda"):
    """Phase a: the tiny MoE, GQA and VideoSwin variants on the card against
    the CPU, fp32 with TF32 off: one pretraining step each to phase 7's
    tolerances (losses 1e-4; with MoE the losses carry ``moe_aux``), and
    greedy and beam-3 ``cap%tva`` sequences equal token for token with the
    decoder logits within 1e-4 (phase 3's checks)."""
    out = {}
    for name, kw in FAMILIES.items():
        out[name] = phase_train_card_vs_cpu(device, cfg_kw=kw)
        if device == "cuda":
            phase_card_vs_cpu(dataclasses.replace(tiny_config(), **kw))
    return out


def largest_batch(config: str, task: str, n_txt: int = 40, overrides=None) -> tuple:
    """The largest of 64, 32, 16 and 8 at which one training step of
    ``configs/<config>``'s model (``overrides`` applied) on a synthetic batch
    of ``task`` (4 frames, 1 clip, ``n_txt`` tokens) fits on the card, tried from the largest, one step each, until
    one does not run out of memory; and {batch: peak GiB or "out of memory"}.
    The weights are N(0, 0.02) drawn on the card: only the memory counts."""
    import torch

    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import pretrain_batch
    from valor_tpu_torch.models.valor import VALORModel
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, moe_aux_weight_for, train_step

    candidates = (64, 32, 16, 8)
    full = load_config(str(ROOT / "configs" / config), overrides)
    m = full.model
    model = VALORModel(m, device="cuda")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02)
    state = TrainState(model.train(), build_optimizer(model, full.train, m.frozen_vision, m.frozen_multimodal))
    spec, tried, found = parse_task(task), {}, None
    aux_w = moe_aux_weight_for(m)
    for b in candidates:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            batch = {k: torch.from_numpy(v).cuda() for k, v in pretrain_batch(m, b, 4, 1, n_txt).items()}
            train_step(state, batch, spec, 0, full.train.grad_dtype, aux_w)
            torch.cuda.synchronize()
            tried[b] = torch.cuda.max_memory_allocated() / 2**30
            found = b
        except torch.OutOfMemoryError:
            tried[b] = "out of memory"
        batch = None
        if found:
            break
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"largest batch of {config} {overrides or ''} on {task}: {found} (peak GiB by batch {tried})")
    if found is None:
        raise AssertionError(f"{config}: no batch of {candidates} fits on the card")
    return found, tried


def swin_ln_launches(steps: int, val_batches: int) -> dict:
    """K1 launches of phase d's VideoSwin tower by width, {C: [forward,
    backward]}: each of its LayerNorms of width C once a training step both
    ways and once a validation batch forward (phase d checks that the path's
    total equals the model's count)."""
    from collections import Counter

    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.valor import VALORModel
    from valor_tpu_torch.ops.layers import LayerNorm

    model = VALORModel(load_config(str(ROOT / "configs" / "caption-msrvtt.json"), SWIN_CAPTION).model, "meta")
    widths = Counter(m.weight.shape[0] for m in model.video_encoder.modules() if isinstance(m, LayerNorm))
    return {c: [n * (steps + val_batches), n * steps] for c, n in sorted(widths.items())}


def phase_gqa_serving(kv_heads: int = 4):
    """Phase e, serving: ``configs/caption-valor32k.json`` with
    ``fusion_cross_attn_kv_heads`` ``kv_heads`` (bf16, seeded random weights)
    through phase 4's checks and rates at bucket 16, and the bytes of a
    bucket-16 batch's cross-attention K/V cache against the same cache at
    every head."""
    import torch

    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import init_params, load_model

    cfg = load_config(str(ROOT / "configs" / "caption-valor32k.json"),
                      {"fusion_cross_attn_kv_heads": kv_heads}).model
    model = load_model(cfg, init_params(cfg, seed=0, device="cuda"), "cuda")
    summary = phase_serving(model, cfg)
    batch = _stack(_items(cfg, 16))
    with torch.inference_mode():
        v = model.video_fusion_input(model.encode_video(torch.from_numpy(batch["video_pixels"]).cuda()))
        a = model.audio_fusion_input(model.encode_audio(torch.from_numpy(batch["audio_spectrograms"]).cuda()))
        kv = model.fusion_cross_kv(v, a)
    heads = {t.shape[1] for layer in kv for pair in layer.values() for t in pair}
    if heads != {kv_heads}:
        raise AssertionError(f"cross-K/V cache heads {heads}, expected {kv_heads}")
    nbytes = sum(t.numel() * t.element_size() for layer in kv for pair in layer.values() for t in pair)
    summary.update(kv_heads=kv_heads, heads=cfg.fusion_heads, cross_kv_bytes_bucket16=nbytes,
                   cross_kv_bytes_at_every_head=nbytes * cfg.fusion_heads // kv_heads)
    log("gqa_serving " + json.dumps({k: v for k, v in summary.items() if k != "layernorm_calls"}))
    del model, kv, v, a
    return summary


FAMILY_STEPS = 5  # phases b and c, from disk


def phases_families(cli_paths: dict, cap_paths: dict, pt=None):
    """Phases a-e on phase 14's (``cli_paths``) and phase 15's (``cap_paths``)
    datasets; ``pt`` is phase 18's summary, which phase b's rate is set
    against.  Returns {path name: summary}."""
    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"families_card_vs_cpu": phase_families_card_vs_cpu()}
    moe = phase_cli_pt_prompts(cli_paths, steps=FAMILY_STEPS, config="pretrain-valor-base-moe.json", prompts=False,
                               label="cli_moe")
    if pt:
        moe["phase18_samples_per_s"] = pt["samples_per_s"]
        moe["over_phase18"] = moe["samples_per_s"] / pt["samples_per_s"]
    out["moe_train"] = moe
    free()
    batch, tried = largest_batch("pretrain-valor-large.json", PT_TASK)
    out["large_train"] = dict(phase_cli_pt_prompts(cli_paths, steps=FAMILY_STEPS, batch_size=batch,
                                                   config="pretrain-valor-large.json", label="cli_large"),
                              batch_probe=tried)
    free()
    batch, tried = largest_batch("caption-msrvtt.json", "cap%tva", n_txt=30, overrides=SWIN_CAPTION)
    swin = phase_cli_finetune("cap", cap_paths, steps=5, batch_size=batch,
                              overrides=dict(SWIN_CAPTION, first_eval=False), label="cli_swin_cap")
    swin["batch_probe"] = tried
    swin["swin_layernorm_widths"] = sorted({c for _, c, eps, *_ in swin["layernorm_calls"] if eps == 1e-5})
    swin["swin_layernorm_launches_by_width"] = swin_ln_launches(swin["steps"], swin["val_batches"])
    log("swin " + json.dumps({k: swin[k] for k in ("batch_probe", "swin_layernorm_widths",
                                                   "swin_layernorm_launches_by_width")}))
    out["swin_cap_train"] = swin
    free()
    out["gqa_serving"] = phase_gqa_serving()
    free()
    out["mscoco_train"] = phase_pretrain(batch_size=64, steps=10, config="caption-mscoco.json", task="cap%tv",
                                         frames=1, n_txt=30, label="mscoco_392")
    free()
    return out


# -- phase f: data parallelism across processes ------------------------------------
DDP_WORLD = 2
DDP_TOL = 1e-5  # phase f (i), absolute and relative: fp32 with TF32 off, sums in another order
NCCL_TOL = 1e-6  # phase f (iii): one NCCL rank against one process, the same arithmetic
FSDP_TOL = 1e-5  # phase f (vi): fsdp against the replicated ranks, absolute and relative (the gathers are exact;
# the clip's norm sums the blocks' squares in another order)
TP_TOL = 2e-2  # phase f (vii): tensor parallelism's first-step losses against (ii)'s, absolute and relative: in bf16
# each row-parallel product is rounded (2^-9 relative) before the model axis sums the two halves, where one process
# rounds the whole product once; the difference runs through the 12-layer towers and the fusion stack (5 bf16 ulps)
TP_NORM_TOL = 5e-2  # and its first grad norm, relative: the norm of bf16 gradients moves with that rounding as it
# moves between bf16 and fp32 (1.3 % between one bf16 and one fp32 process of the tiny config on the CPU)
# (viii) holds expert and sequence parallelism to a plain process with the same two tolerances: the model axis
# sums the same bf16 partial products (experts' outputs, row-parallel products) before its reduce-scatters
MODEL_COLLECTIVES = ("all_gather_dim", "reduce_scatter_dim", "model_all_reduce_")  # (viii)'s, over the model axis


def _take(batch: dict, rows) -> dict:
    """Rows ``rows`` of every array and list of a batch."""
    return {k: ([v[i] for i in rows] if isinstance(v, list) else v[rows]) for k, v in batch.items()}


def ddp_tiny_step(cfg, batch: dict, gallery: dict, eval_batch: int, shard: int = 0, n_shards: int = 1,
                  device: str = "cuda") -> dict:
    """Phase f (i) on one rank (or one process): one ``pt`` step on ``batch``
    (dropout and unimlm masks drawn, an AdamW update) and ``validate_ret``
    over this shard's batches of ``gallery``, on the card, fp32, TF32 off."""
    import torch

    from valor_tpu_torch.core.config import TrainConfig
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.loader import ShardedBatchSampler
    from valor_tpu_torch.eval.validate import validate_ret
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.train.optimizer import build_optimizer, global_norm
    from valor_tpu_torch.train.step import eval_step, losses_and_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr = 1e-3
    model = train_model(cfg, init_params(cfg, seed=0, device=device), device)
    opt = build_optimizer(model, TrainConfig(learning_rate=lr, clip_lr=lr, clip_lr_text=lr,
                                             num_train_steps=10, grad_norm=0.5))
    fwd = K.LAUNCHES
    metrics, grads = losses_and_grads(model, {k: torch.from_numpy(v).to(device) for k, v in batch.items()},
                                      parse_task(PT_TASK), 11)
    opt.update(grads)
    out = {"losses": {k: float(v) for k, v in metrics.items()}, "grad_norm": float(global_norm(grads)),
           "params": [p.detach().cpu() for p in model.parameters()], "layernorm_launches": K.LAUNCHES - fwd}
    n = len(gallery["ids"])
    sampler = ShardedBatchSampler(n, eval_batch, shard, n_shards, shuffle=False)
    out["report"] = validate_ret(model, eval_step, [_take(gallery, idx) for idx in sampler],
                                 parse_task(RET_TASK), cfg.contra_type)
    return out


def ddp_tiny_inputs():
    """Phase f (i)'s config, global batch of 8 and gallery of 9 items."""
    from valor_tpu_torch.data.synthetic import pretrain_batch, retrieval_batch

    cfg = dataclasses.replace(tiny_config(), dropout=0.1, caption_type="unimlm")
    return (cfg, pretrain_batch(cfg, 8, frames=2, clips=1, n_txt=8, seed=21),
            retrieval_batch(cfg, 9, frames=2, clips=1, n_txt=8, seed=22))


def _worker_tiny(device: str) -> dict:
    """Phase f (i) on this rank of ``ddp_worker``'s group: its rows r::W of
    the batch, ``validate_ret`` over its shards of the gallery in batches of 2
    (TF32 set back as it was for the flows that follow)."""
    import torch

    from valor_tpu_torch.parallel import mesh as P

    cfg, batch, gallery = ddp_tiny_inputs()
    r, w = P.rank(), P.world_size()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        out = ddp_tiny_step(cfg, _take(batch, slice(r, None, w)), gallery, 2, r, w, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    return dict(out, params=[p.tolist() for p in out["params"]], device=str(dev),
                backend=torch.distributed.get_backend())


def check_ddp_tiny(ranks: list, device: str = "cuda") -> dict:
    """Phase f (i): the tiny config, fp32, on the card: 2 gloo ranks of 4 rows
    (each rank rows r::2 of the global batch; ``ranks``, the first flow of
    phase f's two-rank launch) against 1 process of 8, one ``pt`` step with
    dropout and masks drawn; every loss, the grad norm and every updated
    parameter within ``DDP_TOL`` (absolute and relative, as the tests'
    ``assert_allclose``); ``validate_ret`` over 9 items (5 and 4 a rank, the
    last batch ragged) equal to one process's report."""
    import torch

    cfg, batch, gallery = ddp_tiny_inputs()
    t0 = time.monotonic()
    one = ddp_tiny_step(cfg, batch, gallery, 4, device=device)
    ranks = [dict(r, params=[torch.tensor(p, dtype=torch.float32) for p in r["params"]]) for r in ranks]
    rank_device = "cuda:0" if device == "cuda" else device
    errs = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0}  # max |a - b|
    worst = 0.0  # max |a - b| - DDP_TOL * |b|: within DDP_TOL as np.allclose(rtol=atol=DDP_TOL) reads it

    def off(a, b):
        return float((a - b).abs().max()), float(((a - b).abs() - DDP_TOL * b.abs()).max())

    for r in ranks:
        if r["backend"] != "gloo" or r["device"] != rank_device or r["losses"].keys() != one["losses"].keys():
            raise AssertionError(f"phase f (i) rank ran {r['backend']} on {r['device']}, losses {r['losses']}")
        pairs = {"loss": [(torch.tensor(r["losses"][k]), torch.tensor(v)) for k, v in one["losses"].items()],
                 "grad_norm": [(torch.tensor(r["grad_norm"]), torch.tensor(one["grad_norm"]))],
                 "param": list(zip(r["params"], one["params"]))}
        for what, ab in pairs.items():
            for a, b in ab:
                e, w = off(a, b)
                errs[what], worst = max(errs[what], e), max(worst, w)
        if r["report"] != one["report"]:
            raise AssertionError(f"phase f (i) validate_ret of a rank {r['report']} != one process's {one['report']}")
        if r["layernorm_launches"] != one["layernorm_launches"] or (device == "cuda") != bool(r["layernorm_launches"]):
            raise AssertionError(f"phase f (i) K1 launches {r['layernorm_launches']} != {one['layernorm_launches']}")
    if worst > DDP_TOL:
        raise AssertionError(f"phase f (i): 2 ranks x 4 against 1 x 8 differ by {errs} (tolerance {DDP_TOL} "
                             "absolute and relative)")
    out = {"world": DDP_WORLD, "backend": "gloo", "losses": one["losses"], "grad_norm": one["grad_norm"],
           "max_abs_err": errs, "tolerance": DDP_TOL, "report": one["report"],
           "one_process_seconds": time.monotonic() - t0}
    log("ddp tiny " + json.dumps(out))
    return out


class _Counted:
    """A loader's batches, counting their items, with its ``sampler``
    (``validate_pt`` reads it for the evaluation shards)."""

    def __init__(self, loader):
        self.loader, self.items = loader, 0
        self.sampler = getattr(loader, "sampler", None)

    def __iter__(self):
        for b in self.loader:
            self.items += len(b["ids"])
            yield b


ZERO_TOL = 1e-5  # phase f (v): ZeRO-1 against the replicated optimizer, absolute and relative (the clip's norm
# sums the blocks' squares in another order)
DDP_STEPS = 3  # steps of phase f's full-width run (iv); (ii), (v)-(ix) take one fewer
REPLICATED_MOMENT_BYTES = 2 * 4 * 374_089_791  # fp32 mu and nu of VALOR-base's parameters on every rank


def state_digest(state) -> dict:
    """Two wrapping int64 sums of the bits of every tensor a checkpoint
    holds: "params", the parameters (gathered whole where the mesh splits
    them, a collective which every rank calls) and the counters, the same on
    every rank; "optimizer", the moments and the accumulator as a checkpoint
    takes them (gathered whole on rank 0, and a rank's blocks elsewhere).
    Equal digests are equal states, bar a collision."""
    import torch

    from valor_tpu_torch.parallel.partition import whole_state_dict

    opt = state.optimizer.state_dict()
    bits_of = {2: torch.int16, 4: torch.int32, 8: torch.int64}

    def sums(tensors):
        out = []
        for t in tensors:
            bits = t.detach().contiguous().view(bits_of[t.element_size()]).reshape(-1).long()
            out += [bits.sum(), (bits * (torch.arange(bits.numel(), device=bits.device) % 65521 + 1)).sum()]
        return torch.stack(out).tolist()

    counters = [state.step, opt["count"], opt["mini_step"], opt["gradient_step"]]
    return {"params": sums(whole_state_dict(state.model).values()) + counters,
            "optimizer": sums(opt["mu"] + opt["nu"] + (opt["acc"] or []))}


def _flag(argv, name, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def ddp_worker(out_dir: str, flows_path: str) -> int:
    """One process of phase f under ``torch.distributed.run`` (or alone): the
    flows listed in ``flows_path`` (JSON), one after the other in one process
    group (joined here once), each ``cli.train``'s ``main`` with this smoke's
    recorders, the kernel counts set to 0 just before it and read just after,
    and every collective of the data axis (the gradient all-reduce,
    ZeRO-1's reduce-scatter and gathers, SCST's gather of the rollouts) timed
    between two synchronisations; writes ``<out_dir>/rank<RANK>.json``, a
    summary a flow.  A flow: ``name``; ``argv``, ``cli.train``'s (the first
    flow's ``--device`` and ``--dist_backend`` set the group's); and, where
    true, ``deterministic`` (under ``torch.use_deterministic_algorithms``),
    ``no_save`` (no checkpoint written; the run still meets at the save's
    barrier), ``scst`` (its parts recorded) and ``digest`` (``state_digest``
    of the final state; every restore's is recorded always).  The process's
    standard error (its native libraries' too) goes to
    ``<out_dir>/rank<RANK>.err``, with the Python stacks of every thread
    should the process die on a signal."""
    import faulthandler
    import signal

    err = open(os.path.join(out_dir, f"rank{os.environ.get('RANK', 0)}.err"), "w", buffering=1)
    os.dup2(err.fileno(), 2)
    faulthandler.enable(err, all_threads=True)
    faulthandler.register(signal.SIGTERM, err, all_threads=True, chain=True)  # where the launcher stopped it

    import torch

    from valor_tpu_torch.parallel import collectives as C
    from valor_tpu_torch.parallel import mesh as P

    with open(flows_path) as f:
        flows = json.load(f)
    device = _flag(flows[0]["argv"], "--device")
    cuda = device is None or device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if P.launched():
        P.init_data_parallel(_flag(flows[0]["argv"], "--dist_backend"), device)
    timed: dict = {}  # collective -> [(ms, bytes, host start)]
    names = ("all_reduce_mean_", "reduce_scatter_mean", "all_gather_blocks_", "gather_blocks_", "all_gather_rows",
             "all_gather_dim", "reduce_scatter_dim", "model_all_reduce_")
    nbytes = {"reduce_scatter_mean": lambda a, out: 4 * sum(t.numel() for t in a[0]),
              "all_gather_dim": lambda a, out: out.numel() * out.element_size(),
              "reduce_scatter_dim": lambda a, out: a[0].numel() * a[0].element_size(),
              "model_all_reduce_": lambda a, out: out.numel() * out.element_size()}
    originals = {n: getattr(C, n) for n in names}

    def timer(name, fn):
        def wrapped(*a, **kw):
            if not P.is_initialized():  # one process: nothing to reduce
                return fn(*a, **kw)
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            n = out if isinstance(out, int) else nbytes[name](a, out) if name in nbytes else 0
            timed.setdefault(name, []).append(((time.perf_counter() - t0) * 1e3, n, t0))
            return out
        return wrapped

    results = {}
    try:
        for n, fn in originals.items():
            setattr(C, n, timer(n, fn))
        for flow in flows:
            timed.clear()
            t0 = time.perf_counter()
            if flow.get("tiny"):
                results[flow["name"]] = _worker_tiny(device or "cuda")
            elif flow.get("restore"):
                results[flow["name"]] = _worker_restore(flow, device or "cuda")
            else:
                results[flow["name"]] = _worker_flow(flow, cuda, sync, timed)
            results[flow["name"]]["flow_s"] = time.perf_counter() - t0
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        for n, fn in originals.items():
            setattr(C, n, fn)
    rank = P.rank()
    P.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def _worker_flow(flow: dict, cuda: bool, sync, timed: dict) -> dict:
    """One flow of ``ddp_worker``; its summary."""
    import torch

    from valor_tpu_torch.cli.train import main as train_main
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.ops.kernels import fine_score as K2
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.ops.moe import expert_sharding_applied
    from valor_tpu_torch.parallel import collectives as C
    from valor_tpu_torch.parallel import mesh as P
    from valor_tpu_torch.parallel import pipeline as PL
    from valor_tpu_torch.parallel.activations import sequence_sharding_applied
    from valor_tpu_torch.train import checkpoints as TC

    argv = list(flow["argv"])
    cfg = load_config(_flag(argv, "--config"))
    spec = parse_task(cfg.data_train[0].task)
    write0, load0, restored = TC.ModelSaver._write, TC.load_state, []

    def load1(state, payload):
        load0(state, payload)
        restored.append(state_digest(state))

    TC.load_state = load1
    if flow.get("no_save"):
        TC.ModelSaver._write = lambda self, payload, step, best_name, bookkeep=True: None
    torch.use_deterministic_algorithms(bool(flow.get("deterministic")), warn_only=True)
    PL.set_timing(bool(flow.get("pipeline")))  # a pipelined flow times its blocks (synchronising the card)
    C.reset_pipe_stats()
    try:
        with record_trainers(sync, cuda) as runs, record_ln_calls() as (sigs_fwd, sigs_bwd), \
                record_fine_calls() as fine_calls, record_pt_validations(sync) as calls, \
                (record_scst(sync) if flow.get("scst") else contextlib.nullcontext()) as scst:
            K.LAUNCHES = K.LAUNCHES_BWD = K2.LAUNCHES = 0  # the main path starts here
            trainer = train_main(argv)
            launches = (K.LAUNCHES, K.LAUNCHES_BWD, K2.LAUNCHES)  # the main path ends here
            split = (expert_sharding_applied(), sequence_sharding_applied())  # counted since the run built its model
            piped = PL.pipeline_applied()
    finally:
        TC.ModelSaver._write, TC.load_state = write0, load0
        torch.use_deterministic_algorithms(False)
        pipe_stats, pipe_timing, pipe_bubble = dict(C.PIPE_STATS), dict(PL.TIMING), PL.bubble()
        PL.set_timing(False)
    rec, history = runs[0], list(trainer.history)
    model, opt = trainer.state.model, trainer.state.optimizer
    world = P.world_size()
    step_s = np.diff([rec["start"]] + rec["stamps"])
    local_batch = cfg.data_train[0].batch_size // P.batch_world()
    bounds = list(zip([rec["start"]] + rec["stamps"][:-1], rec["stamps"]))
    by_step = {k: {"ms": [sum(t for t, _, t0 in v if lo <= t0 < hi) for lo, hi in bounds],
                   "calls": [sum(lo <= t0 < hi for _, _, t0 in v) for lo, hi in bounds],
                   "bytes": [sum(n for _, n, t0 in v if lo <= t0 < hi) for lo, hi in bounds]}
               for k, v in timed.items()}
    places = getattr(model, "placements", None) or {}
    median = float(np.median(step_s[1:])) if len(step_s) > 1 else float(step_s[0])
    out = {
        "rank": P.rank(), "world": world, "device": str(model.device),
        "backend": torch.distributed.get_backend() if P.is_initialized() else "none (one process)",
        "deterministic": bool(flow.get("deterministic")), "steps": len(history),
        "first_micro_step": history[0][0], "local_batch": local_batch, "global_batch": cfg.data_train[0].batch_size,
        "step_s": [float(v) for v in step_s], "median_step_s": median,
        "samples_per_s_rank": local_batch / median,
        "samples_per_s_global": local_batch * P.batch_world() / median,
        "grid": [P.data_rank(), P.data_world(), P.model_rank(), P.model_world()],
        "pipe": [P.pipe_rank(), P.pipe_world(), P.batch_world()],
        "collectives_by_step": by_step,
        "split_leaves": sum(pl.split for pl in places.values()),
        "model_split_leaves": sum(pl.model_dim is not None for pl in places.values()),
        "data_split_leaves": sum(pl.data_dim is not None for pl in places.values()),
        "max_memory_allocated_gib": rec["peak"] / 2**30,
        "losses": {k: [h[2][k] for h in history] for k in history[0][2]},
        "collectives": {k: {"ms": [t for t, _, _ in v], "bytes": sorted({n for _, n, _ in v})}
                        for k, v in timed.items()},
        "allreduce_ms": [t for t, _, _ in timed.get("all_reduce_mean_", [])],
        "allreduce_bytes": sorted({n for _, n, _ in timed.get("all_reduce_mean_", [])}),
        "param_bytes_fp32": 4 * sum(p.numel() for p in model.parameters()),
        # a step's gradients are this rank's tensors' shapes, fp32 (grad_dtype unset)
        "grad_bytes": sum(p.numel() * (2 if cfg.train.grad_dtype == "bfloat16" else 4) for p in model.parameters()),
        "zero_world": opt.zero_world, "optimizer_state_bytes": opt.state_bytes(),
        "layernorm_launches_fwd_bwd": launches[:2], "fine_score_launches": launches[2],
        "expert_sharding_applied": split[0], "sequence_sharding_applied": split[1],
        "fusion_len": cfg.data_train[0].max_txt_len + 2,  # the text with its CLS and SEP: the caption groups' S
        "ln_per_step": expected_train_ln_launches(model, spec),
        "validations": [{"items": n, "seconds": t, "report": rep} for n, t, rep in calls],
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
        "fine_score_calls": sorted({tuple(s_) for s_, _ in fine_calls}), "restored_digests": restored,
        "digest": state_digest(trainer.state) if flow.get("digest") else None,
    }
    if flow.get("pipeline"):
        out.update(pipeline_applied=piped, pipe_stats=pipe_stats, pipe_timing=pipe_timing, bubble=pipe_bubble,
                   pipelined_passes_a_step=sum(n for _, n, _ in pipelined_encoders(model, spec)),
                   fusion_layers=cfg.model.fusion_layers,
                   transport=C.transport(model.device), microbatches=PL.pipeline_microbatches(
                       cfg.data_train[0].batch_size, P.pipe_world(), P.data_world()),
                   ln_per_step_pipelined=expected_pipelined_ln_launches(model, spec, P.pipe_rank(), P.pipe_world(),
                                                                        PL.pipeline_microbatches(
                                                                            cfg.data_train[0].batch_size,
                                                                            P.pipe_world(), P.data_world())))
    if flow.get("scst"):
        bounds = list(zip([rec["start"]] + rec["stamps"][:-1], rec["stamps"]))
        gathers = [(t0, ms / 1e3) for ms, _, t0 in timed.get("all_gather_rows", [])]
        parts = {}
        for name in ("encode", "greedy_rollout", "sample_rollout", "host_reward", "update"):
            parts[name] = [sum(s_ for p, t0, s_ in scst["parts"] if p == name and lo <= t0 < hi) for lo, hi in bounds]
        parts["gather"] = [sum(s_ for t0, s_ in gathers if lo <= t0 < hi) for lo, hi in bounds]
        a = trainer.alpha
        out.update(scst_parts_s=parts, rewards=scst["rewards"], alpha=[a.value(), a.idx, a.sample_total,
                                                                        a.greedy_total],
                   restored_params_equal=scst["first_step_equal"], max_len=cfg.model.max_generation_len,
                   ln_per_step_fwd_bwd=list(expected_scst_ln_launches(model, spec)))
    del trainer, model, opt
    return out


def _worker_restore(flow: dict, device: str) -> dict:
    """A flow of ``ddp_worker`` that trains nothing: the state of
    ``flow["config"]`` built as ``cli.train`` builds it in this process, the
    latest checkpoint of the run directory ``flow["restore"]`` loaded into it;
    its ``state_digest``."""
    from valor_tpu_torch.cli.build import build_model_and_state
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state

    cfg = load_config(flow["config"])
    state = build_model_and_state(cfg, device)
    load_state(state, ModelSaver(flow["restore"], remove_before_ckpt=False).restore())
    out = {"digest": state_digest(state), "rank": 0, "world": 1}
    del state
    return out


def run_ranks(nproc, flows: list, out_dir: str, timeout=600) -> list:
    """``ddp_worker`` over ``flows`` in ``nproc`` ranks under ``python -m
    torch.distributed.run --standalone`` (``nproc`` None: one process, no
    launcher); a nonzero exit of the launcher, or of the process, fails the
    phase, and at ``timeout`` the whole process group is killed.  Returns each
    rank's summaries, by flow name."""
    import signal

    os.makedirs(out_dir, exist_ok=True)
    flows_path = os.path.join(out_dir, "flows.json")
    with open(flows_path, "w") as f:
        json.dump(flows, f)
    worker = [str(ROOT / "chip_smoke.py"), "--ddp-worker", out_dir, flows_path]
    launcher = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}"] if nproc else []
    log_path = os.path.join(out_dir, "launcher.log")
    t0 = time.monotonic()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, *launcher, *worker], stdout=logf, stderr=subprocess.STDOUT,
                                process_group=0, cwd=str(ROOT))
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)  # nothing it started outlives it
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        for r in range(nproc or 1):  # each rank's own last words come last
            err_path = os.path.join(out_dir, f"rank{r}.err")
            if os.path.exists(err_path):
                with open(err_path, errors="replace") as f:
                    tail += f"\n--- rank {r} standard error, its end ---\n" + f.read()[-4000:]
        raise AssertionError(f"{'launcher' if nproc else 'process'} exit {rc}:\n{tail}")
    out = []
    for r in range(nproc or 1):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    log(f"{nproc or 'one plain'} process(es) of {[f['name'] for f in flows]} in {time.monotonic() - t0:.1f} s; "
        f"rank 0's flows {[round(out[0][f['name']]['flow_s'], 1) for f in flows]} s")
    return out


def _finite(losses: dict) -> bool:
    return all(np.isfinite(v) for vs in losses.values() for v in vs)


def _launch_summary(ranks: list) -> dict:
    """The kernel launches and shapes of a path's ranks, summed."""
    return {
        "layernorm_launches_fwd_bwd": [sum(r["layernorm_launches_fwd_bwd"][i] for r in ranks) for i in (0, 1)],
        "fine_score_launches": sum(r["fine_score_launches"] for r in ranks),
        "layernorm_calls": sorted({tuple(c) for r in ranks for c in r["layernorm_calls"]}),
        "layernorm_bwd_calls": sorted({tuple(c) for r in ranks for c in r["layernorm_bwd_calls"]}),
        "fine_score_calls": sorted({tuple(c) for r in ranks for c in r["fine_score_calls"]}),
    }


def check_ddp_base(ranks: list, steps: int, val_batch: int, n_val: int, device: str, ckpts) -> None:
    """Phase f (ii)'s gates on its ranks' summaries."""
    for r in ranks:
        per_step = r["ln_per_step"]
        val_batches = -(-r["validations"][0]["items"] // (val_batch // DDP_WORLD))
        want = (per_step * (steps + val_batches), per_step * steps, 3) if device == "cuda" else (0, 0, 0)
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["backend"], r["device"]) != (DDP_WORLD, "gloo", "cuda:0" if device == "cuda" else device) \
                or r["steps"] != steps:
            raise AssertionError(f"phase f (ii) rank {r['rank']}: {r['world']} ranks, {r['backend']} on "
                                 f"{r['device']}, {r['steps']} steps")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"phase f (ii) losses of rank {r['rank']}: {r['losses']}, rank 0 {ranks[0]['losses']}")
        if r["allreduce_bytes"] != [r["param_bytes_fp32"]] or len(r["allreduce_ms"]) != steps:
            raise AssertionError(f"phase f (ii) gradient all-reduce {r['allreduce_bytes']} bytes in "
                                 f"{len(r['allreduce_ms'])} calls, parameters {r['param_bytes_fp32']}")
        if got != want:
            raise AssertionError(f"phase f (ii) rank {r['rank']} launches (ln fwd, ln bwd, fine_score) {got} != {want}")
        rep = r["validations"][0]["report"] if len(r["validations"]) == 1 else None
        if rep is None or rep != ranks[0]["validations"][0]["report"] or not all(np.isfinite(v) for v in rep.values()):
            raise AssertionError(f"phase f (ii) validate_pt reports differ or are missing: {r['validations']}")
    if sum(r["validations"][0]["items"] for r in ranks) != n_val or ckpts:
        raise AssertionError(f"phase f (ii): {[r['validations'][0]['items'] for r in ranks]} evaluation items "
                             f"of {n_val}, checkpoints {ckpts}")


def check_ddp_zero(ranks: list, base: list, steps: int, device: str, ckpts) -> dict:
    """Phase f (v)'s gates: ZeRO-1 at two ranks against f (ii)'s replicated
    ranks on the same batches and draws; returns the largest differences."""
    worst, err = 0.0, 0.0
    for r, b in zip(ranks, base):
        per_step = r["ln_per_step"]
        want = (per_step * steps, per_step * steps, 0) if device == "cuda" else (0, 0, 0)
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["zero_world"], r["steps"]) != (DDP_WORLD, DDP_WORLD, steps) or got != want:
            raise AssertionError(f"phase f (v) rank {r['rank']}: {r['world']} ranks, ZeRO over {r['zero_world']}, "
                                 f"{r['steps']} steps, launches {got} != {want}")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"] or r["losses"].keys() != b["losses"].keys():
            raise AssertionError(f"phase f (v) losses of rank {r['rank']}: {r['losses']}")
        for k, vs in b["losses"].items():
            for x, y in zip(r["losses"][k], vs):
                err, worst = max(err, abs(x - y)), max(worst, abs(x - y) - ZERO_TOL * abs(y))
        if not (0 < r["optimizer_state_bytes"] < b["optimizer_state_bytes"]):
            raise AssertionError(f"phase f (v) rank {r['rank']} holds {r['optimizer_state_bytes']} optimizer bytes, "
                                 f"the replicated rank {b['optimizer_state_bytes']}")
        if not {"reduce_scatter_mean", "all_gather_blocks_"} <= set(r["collectives"]):
            raise AssertionError(f"phase f (v) rank {r['rank']} collectives {sorted(r['collectives'])}")
        if r["digest"]["params"] != ranks[0]["digest"]["params"]:
            raise AssertionError("phase f (v): the two ranks' final parameters or counters differ")
    if worst > ZERO_TOL or ckpts != [f"step_{steps}"]:
        raise AssertionError(f"phase f (v): ZeRO-1 losses differ from the replicated ones by {err} (tolerance "
                             f"{ZERO_TOL} absolute and relative); checkpoints {ckpts}")
    return {"max_abs_loss_err": err, "tolerance": ZERO_TOL}


def check_ddp_scst(ranks: list, steps: int, device: str) -> None:
    """Phase f (iv)'s gates: the same alpha and rewards on both ranks, finite
    losses, the caption run's weights at the first step, the launches of the
    path on each rank."""
    for r in ranks:
        per_fwd, per_bwd = r["ln_per_step_fwd_bwd"]
        want = (per_fwd * steps, per_bwd * steps, 0) if device == "cuda" else (0, 0, 0)
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["steps"]) != (DDP_WORLD, steps) or got != want or not r["restored_params_equal"]:
            raise AssertionError(f"phase f (iv) rank {r['rank']}: {r['world']} ranks, {r['steps']} steps, launches "
                                 f"{got} != {want}, restored weights equal {r['restored_params_equal']}")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"phase f (iv) losses of rank {r['rank']}: {r['losses']}")
        if r["alpha"] != ranks[0]["alpha"] or r["rewards"] != ranks[0]["rewards"]:
            raise AssertionError(f"phase f (iv) alpha {r['alpha']} or rewards differ from rank 0's {ranks[0]['alpha']}")
        if any(len(x) != r["global_batch"] for x in r["rewards"]) or len(r["rewards"]) != 2 * steps:
            raise AssertionError(f"phase f (iv) rank {r['rank']}: {[len(x) for x in r['rewards']]} rewards a call")


def check_ddp_fsdp(ranks: list, base: list, steps: int, device: str, ckpts, plain_digest) -> dict:
    """Phase f (vi)'s gates: ``fsdp`` at two ranks against f (ii)'s
    replicated ranks on the same batches and draws: every loss and grad norm
    within ``FSDP_TOL``, fewer parameter, gradient and optimizer bytes a rank,
    the gathers and reduce-scatters timed, the launches of the path, and one
    whole checkpoint that a plain process restores to (vi)'s own state;
    returns the largest difference."""
    worst, err = 0.0, 0.0
    for r, b in zip(ranks, base):
        per_step = r["ln_per_step"]
        want = (per_step * steps, per_step * steps, 0) if device == "cuda" else (0, 0, 0)
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["grid"][1], r["steps"]) != (DDP_WORLD, DDP_WORLD, steps) or got != want \
                or not r["data_split_leaves"]:
            raise AssertionError(f"phase f (vi) rank {r['rank']}: {r['world']} ranks, grid {r['grid']}, "
                                 f"{r['steps']} steps, {r['data_split_leaves']} split leaves, launches {got} != {want}")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"] or r["losses"].keys() != b["losses"].keys():
            raise AssertionError(f"phase f (vi) losses of rank {r['rank']}: {r['losses']}")
        for k, vs in b["losses"].items():
            for x, y in zip(r["losses"][k], vs):
                err, worst = max(err, abs(x - y)), max(worst, abs(x - y) - FSDP_TOL * abs(y))
        for key in ("param_bytes_fp32", "grad_bytes", "optimizer_state_bytes"):  # about half at full width
            if not (0 < r[key] < (0.75 if device == "cuda" else 1.0) * b[key]):
                raise AssertionError(f"phase f (vi) rank {r['rank']} holds {r[key]} {key}, the replicated rank {b[key]}")
        if not {"all_gather_dim", "reduce_scatter_dim"} <= set(r["collectives"]):
            raise AssertionError(f"phase f (vi) rank {r['rank']} collectives {sorted(r['collectives'])}")
        if r["digest"]["params"] != ranks[0]["digest"]["params"]:
            raise AssertionError("phase f (vi): the two ranks' whole parameters or counters differ")
    if worst > FSDP_TOL or ckpts != [f"step_{steps}"]:
        raise AssertionError(f"phase f (vi): fsdp losses differ from the replicated ones by {err} (tolerance "
                             f"{FSDP_TOL} absolute and relative); checkpoints {ckpts}")
    if plain_digest != ranks[0]["digest"]:
        raise AssertionError("phase f (vi): a plain process restored another state than the fsdp ranks saved")
    return {"max_abs_loss_err": err, "tolerance": FSDP_TOL}


def check_ddp_tp(ranks: list, base: list, steps: int, val_batch: int, n_val: int, device: str, ckpts) -> dict:
    """Phase f (vii)'s gates: tensor parallelism at data 1 x model 2, both
    ranks on the global batch: the same losses and reports on both, the first
    step's losses within ``TP_TOL`` of f (ii)'s, finite losses after, fewer
    parameter bytes a rank, the model axis's all-reduces timed, the launches of
    the path; returns the first step's largest difference."""
    worst, err = 0.0, 0.0
    for r in ranks:
        per_step = r["ln_per_step"]
        val_batches = -(-r["validations"][0]["items"] // val_batch) if r["validations"] else 0
        want = (per_step * (steps + val_batches), per_step * steps, 3) if device == "cuda" else (0, 0, 0)
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["grid"][1:], r["steps"]) != (DDP_WORLD, [1, r["rank"], DDP_WORLD], steps) or got != want \
                or not r["model_split_leaves"]:
            raise AssertionError(f"phase f (vii) rank {r['rank']}: {r['world']} ranks, grid {r['grid']}, "
                                 f"{r['steps']} steps, {r['model_split_leaves']} split leaves, launches {got} != {want}")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"phase f (vii) losses of rank {r['rank']}: {r['losses']}, rank 0 {ranks[0]['losses']}")
        if not 0 < r["param_bytes_fp32"] < (0.75 if device == "cuda" else 1.0) * base[0]["param_bytes_fp32"] \
                or "model_all_reduce_" not in r["collectives"]:
            raise AssertionError(f"phase f (vii) rank {r['rank']}: {r['param_bytes_fp32']} parameter bytes, "
                                 f"collectives {sorted(r['collectives'])}")
        rep = r["validations"][0]["report"] if len(r["validations"]) == 1 else None
        if rep is None or rep != ranks[0]["validations"][0]["report"] or not all(np.isfinite(v) for v in rep.values()) \
                or r["validations"][0]["items"] != n_val:
            raise AssertionError(f"phase f (vii) validate_pt reports differ or are missing: {r['validations']}")
    for k, vs in base[0]["losses"].items():
        if k == "grad_norm":
            continue
        x, y = ranks[0]["losses"][k][0], vs[0]
        err, worst = max(err, abs(x - y)), max(worst, abs(x - y) - TP_TOL * abs(y))
    norm, norm0 = ranks[0]["losses"]["grad_norm"][0], base[0]["losses"]["grad_norm"][0]
    if worst > TP_TOL or abs(norm - norm0) > TP_NORM_TOL * norm0 or ckpts:
        raise AssertionError(f"phase f (vii): the first step's losses differ from (ii)'s by {err} (tolerance "
                             f"{TP_TOL} absolute and relative), its grad norm {norm} from {norm0} (tolerance "
                             f"{TP_NORM_TOL} relative); checkpoints {ckpts}")
    return {"first_step_max_abs_loss_err": err, "tolerance": TP_TOL,
            "first_step_grad_norm_rel_err": abs(norm - norm0) / norm0, "grad_norm_tolerance": TP_NORM_TOL}


def check_ddp_ep_sp(ranks: list, one: dict, steps: int, val_batch: int, n_val: int, device: str, ckpts) -> dict:
    """Phase f (viii)'s gates: expert and sequence parallelism (with tensor
    parallelism) at data 1 x model 2, both ranks on the global batch: both
    counts above 0 on each rank, the same losses and reports on both, the
    first step's losses within ``TP_TOL`` of the plain process ``one`` on the
    same flow and batches (its grad norm within ``TP_NORM_TOL``), finite losses
    after, the launches of the path; returns the first step's largest
    differences."""
    for r in ranks:
        if r["sequence_sharding_applied"] == 0 and r["fusion_len"] % DDP_WORLD:
            raise AssertionError(f"phase f (viii): the fusion sequence of {r['fusion_len']} tokens does not divide "
                                 f"the model axis of {DDP_WORLD} ranks, so sequence parallelism cannot engage")
        if min(r["expert_sharding_applied"], r["sequence_sharding_applied"]) <= 0:
            raise AssertionError(f"phase f (viii) rank {r['rank']}: {r['expert_sharding_applied']} expert-split and "
                                 f"{r['sequence_sharding_applied']} sequence-split forwards")
        per_step = r["ln_per_step"]
        val_batches = -(-r["validations"][0]["items"] // val_batch) if r["validations"] else 0
        want = (per_step * (steps + val_batches), per_step * steps, 3) if device == "cuda" else (0, 0, 0)
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["grid"][1:], r["steps"]) != (DDP_WORLD, [1, r["rank"], DDP_WORLD], steps) or got != want:
            raise AssertionError(f"phase f (viii) rank {r['rank']}: {r['world']} ranks, grid {r['grid']}, "
                                 f"{r['steps']} steps, launches {got} != {want}")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"] or "moe_aux" not in r["losses"]:
            raise AssertionError(f"phase f (viii) losses of rank {r['rank']}: {r['losses']}, rank 0 {ranks[0]['losses']}")
        if not set(MODEL_COLLECTIVES) <= set(r["collectives"]):
            raise AssertionError(f"phase f (viii) rank {r['rank']} collectives {sorted(r['collectives'])}")
        rep = r["validations"][0]["report"] if len(r["validations"]) == 1 else None
        if rep is None or rep != ranks[0]["validations"][0]["report"] or not all(np.isfinite(v) for v in rep.values()) \
                or r["validations"][0]["items"] != n_val:
            raise AssertionError(f"phase f (viii) validate_pt reports differ or are missing: {r['validations']}")
    if (one["world"], one["expert_sharding_applied"], one["sequence_sharding_applied"]) != (1, 0, 0) \
            or one["losses"].keys() != ranks[0]["losses"].keys():
        raise AssertionError(f"phase f (viii): the plain process ran at {one['world']} ranks, split "
                             f"{one['expert_sharding_applied']} and {one['sequence_sharding_applied']} forwards, "
                             f"losses {sorted(one['losses'])}")
    worst, err = 0.0, 0.0
    for k, vs in one["losses"].items():
        if k == "grad_norm":
            continue
        x, y = ranks[0]["losses"][k][0], vs[0]
        err, worst = max(err, abs(x - y)), max(worst, abs(x - y) - TP_TOL * abs(y))
    norm, norm0 = ranks[0]["losses"]["grad_norm"][0], one["losses"]["grad_norm"][0]
    if worst > TP_TOL or abs(norm - norm0) > TP_NORM_TOL * norm0 or ckpts:
        raise AssertionError(f"phase f (viii): the first step's losses differ from the plain process's by {err} "
                             f"(tolerance {TP_TOL} absolute and relative), its grad norm {norm} from {norm0} "
                             f"(tolerance {TP_NORM_TOL} relative); checkpoints {ckpts}")
    return {"first_step_max_abs_loss_err": err, "tolerance": TP_TOL,
            "first_step_grad_norm_rel_err": abs(norm - norm0) / norm0, "grad_norm_tolerance": TP_NORM_TOL}


def check_ddp_pp(ranks: list, base: list, steps: int, val_batch: int, n_val: int, device: str, ckpts) -> dict:
    """Phase f (ix)'s gates: the fusion stack pipelined over data 1 x pipe 2,
    16 rows a rank at the towers: the stack ran pipelined on both ranks (every
    pass of every step, ``pipelined_encoders``), the same losses and reports on both,
    the first step's losses within ``TP_TOL`` of f (ii)'s on the same batches
    (its grad norm within ``TP_NORM_TOL``), the launches of a pipe rank (its
    stage's fusion layers once a microbatch; ``validate_pt`` runs the stack
    whole), stage sends and the pipe's gathers and hand-backs on both ranks;
    returns the first step's largest differences."""
    for r in ranks:
        passes = steps * r["pipelined_passes_a_step"]
        val_batches = -(-r["validations"][0]["items"] // (val_batch // DDP_WORLD)) if r["validations"] else 0
        want = ((r["ln_per_step_pipelined"] * steps + r["ln_per_step"] * val_batches,
                 r["ln_per_step_pipelined"] * steps, 3) if device == "cuda" else (0, 0, 0))
        got = (*r["layernorm_launches_fwd_bwd"], r["fine_score_launches"])
        if (r["world"], r["grid"], r["pipe"], r["steps"]) != (DDP_WORLD, [0, 1, 0, 1], [r["rank"], DDP_WORLD, DDP_WORLD],
                                                             steps) or got != want:
            raise AssertionError(f"phase f (ix) rank {r['rank']}: {r['world']} ranks, grid {r['grid']} pipe "
                                 f"{r['pipe']}, {r['steps']} steps, launches {got} != {want}")
        st = r["pipe_stats"]
        if r["pipeline_applied"] != passes or min(st["sends"], st["gathers"], st["hand_backs"]) <= 0:
            raise AssertionError(f"phase f (ix) rank {r['rank']}: {r['pipeline_applied']} pipelined passes of "
                                 f"{passes}, pipe traffic {st}")
        if not _finite(r["losses"]) or r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"phase f (ix) losses of rank {r['rank']}: {r['losses']}, rank 0 {ranks[0]['losses']}")
        rep = r["validations"][0]["report"] if len(r["validations"]) == 1 else None
        if rep is None or rep != ranks[0]["validations"][0]["report"] or not all(np.isfinite(v) for v in rep.values()):
            raise AssertionError(f"phase f (ix) validate_pt reports differ or are missing: {r['validations']}")
    if sum(r["validations"][0]["items"] for r in ranks) != n_val or ckpts:
        raise AssertionError(f"phase f (ix): {[r['validations'][0]['items'] for r in ranks]} evaluation items "
                             f"of {n_val}, checkpoints {ckpts}")
    worst, err = 0.0, 0.0
    for k, vs in base[0]["losses"].items():
        if k == "grad_norm":
            continue
        x, y = ranks[0]["losses"][k][0], vs[0]
        err, worst = max(err, abs(x - y)), max(worst, abs(x - y) - TP_TOL * abs(y))
    norm, norm0 = ranks[0]["losses"]["grad_norm"][0], base[0]["losses"]["grad_norm"][0]
    if worst > TP_TOL or abs(norm - norm0) > TP_NORM_TOL * norm0:
        raise AssertionError(f"phase f (ix): the first step's losses differ from (ii)'s by {err} (tolerance "
                             f"{TP_TOL} absolute and relative), its grad norm {norm} from {norm0} (tolerance "
                             f"{TP_NORM_TOL} relative)")
    return {"first_step_max_abs_loss_err": err, "tolerance": TP_TOL,
            "first_step_grad_norm_rel_err": abs(norm - norm0) / norm0, "grad_norm_tolerance": TP_NORM_TOL}


def cli_config(paths: dict, tmp: str, name: str, label: str, edit) -> str:
    """``configs/<name>`` with ``edit(raw)`` applied, written under ``tmp`` as
    ``config_<label>.json``; its path (``cli_run`` without the environment,
    for configs that one launch runs together)."""
    raw = json.loads((ROOT / "configs" / name).read_text())
    edit(raw)
    path = os.path.join(tmp, f"config_{label}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@contextlib.contextmanager
def env_for(paths: dict):
    """The tokenizer paths of ``paths`` (every synthetic dataset writes the
    same files) and no public encoder weights, in the environment inside the
    block."""
    keys = ("VALOR_BERT_VOCAB", "VALOR_CLIP_BPE", "VALOR_PRETRAINED_DIR")
    env0 = {k: os.environ.get(k) for k in keys}
    os.environ.update(VALOR_BERT_VOCAB=paths["vocab"], VALOR_CLIP_BPE=paths["merges"],
                      VALOR_PRETRAINED_DIR=os.path.join(os.path.dirname(paths["vocab"]), "no_public_weights"))
    try:
        yield
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_ddp(cap_paths: dict, cap_run: str, pt=None, device: str = "cuda", overrides=None,
              fixture=None, scst_overrides=None, steps: int = DDP_STEPS, batch_size: int = 32,
              val_batch: int = 64, n_val: int = 64) -> dict:
    """Phase f: (i), then (ii), (v), (iv), (vi), (vii), (viii) and (ix) in one
    launch of two gloo ranks, then (iii), (v)'s checkpoint resumed at one NCCL
    rank and in a plain process (which also restores (vi)'s and runs (viii)'s
    flow for its reference), the two processes side by side; a summary a path.  (ii) and (v) train on a dataset written here
    that draws nothing at random on the host (one caption an id, 4 frames and
    one audio clip an item), the same batches in both, and (iii) trains on it
    too; (iv)
    takes phase 15's dataset (``cap_paths``) and caption run (``cap_run``).
    ``device``, ``overrides``, ``fixture`` and ``scst_overrides`` shrink the
    runs for a CPU rehearsal (``device`` "cpu", gloo in place of NCCL)."""
    import torch

    from valor_tpu_torch.data.synthetic import write_retrieval_dataset

    t0 = time.monotonic()
    cuda = device == "cuda"
    short = max(2, steps - 1)  # (ii), (v)-(ix): one schedule, so their steps compare
    if cuda:
        free, total = torch.cuda.mem_get_info()
        with open("/proc/meminfo") as f:
            host_free = next(int(ln.split()[1]) * 1024 for ln in f if ln.startswith("MemAvailable"))
        log(f"phase f starts: card {free / 2**30:.2f} of {total / 2**30:.2f} GiB free, this process holding "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB; host {host_free / 2**30:.2f} GiB available; "
            f"{shutil.disk_usage(tempfile.gettempdir()).free / 2**30:.2f} GiB free in {tempfile.gettempdir()}")
    out = {}
    dev = [] if cuda else ["--device", device]
    with tempfile.TemporaryDirectory(prefix="valor_ddp_") as tmp:
        data = write_retrieval_dataset(os.path.join(tmp, "data"), n_train=steps * batch_size, n_val=n_val,
                                       **dict(dict(n_frames=4, wav_seconds=4.0, captions_per_train_id=1),
                                              **(fixture or {})))
        written_s = time.monotonic() - t0

        def pt_config(name, val, config="pretrain-valor-base.json", n_steps=steps):
            return cli_config(data, tmp, config, name, lambda raw: first_pt_flow(
                raw, data, os.path.join(tmp, name), n_steps, batch_size, val, False, overrides))

        def scst_edit(raw):
            point_at(raw, cap_paths)
            raw["data_cfg"]["val"] = []
            raw["data_cfg"]["train"][0]["batch_size"] = batch_size
            raw.update(output_dir=os.path.join(tmp, "scst"), num_train_steps=steps, valid_steps=0,
                       first_eval=False, **(scst_overrides or overrides or {}))

        base_cfg, zero_cfg = pt_config("base", val_batch, n_steps=short), pt_config("zero", None, n_steps=short)
        fsdp_cfg, tp_cfg = pt_config("fsdp", None, n_steps=short), pt_config("tp", val_batch, n_steps=short)
        moe = "pretrain-valor-base-moe.json"
        ep_sp_cfg = pt_config("ep_sp", val_batch, moe, n_steps=short)
        ep_sp_one_cfg = pt_config("ep_sp_one", None, moe, n_steps=short)
        pp_cfg = pt_config("pp", val_batch, n_steps=short)
        scst_cfg = cli_config(cap_paths, tmp, "caption-msrvtt.json", "scst", scst_edit)
        gloo = ["--dist_backend", "gloo", *dev]
        with env_for(data):
            two = run_ranks(DDP_WORLD, [
                {"name": "tiny", "argv": gloo, "tiny": True},
                {"name": "base", "argv": ["--config", base_cfg, *gloo], "deterministic": True, "no_save": True},
                {"name": "zero", "argv": ["--config", zero_cfg, "--zero_optimizer", "true", "--async_checkpoint",
                                          "true", *gloo], "deterministic": True, "digest": True},
                {"name": "scst", "argv": ["--config", scst_cfg, "--scst_finetuning", "true", "--pretrain_dir",
                                          cap_run, *gloo], "scst": True, "no_save": True},
                {"name": "fsdp", "argv": ["--config", fsdp_cfg, "--fsdp", "true", *gloo], "deterministic": True,
                 "digest": True},
                {"name": "tp", "argv": ["--config", tp_cfg, "--model_shards", str(DDP_WORLD), *gloo],
                 "deterministic": True, "no_save": True},
                {"name": "ep_sp", "argv": ["--config", ep_sp_cfg, "--model_shards", str(DDP_WORLD),
                                           "--sequence_parallel", "true", *gloo], "deterministic": True,
                 "no_save": True},
                {"name": "pp", "argv": ["--config", pp_cfg, "--fusion_pipeline_stages", str(DDP_WORLD), *gloo],
                 "deterministic": True, "no_save": True, "pipeline": True},
            ], os.path.join(tmp, "two"), timeout=1000)
            ckpts = {k: sorted(os.listdir(os.path.join(tmp, k, "ckpt")))
                     for k in ("base", "zero", "fsdp", "tp", "ep_sp", "pp")}
            # (iii): one NCCL rank and one plain process, each resuming (v)'s checkpoint for ``steps`` more steps,
            # side by side (each only reads what the two ranks wrote, and saves nothing)
            resume = ["--resume", "true", "--num_train_steps", str(short + steps), "--zero_optimizer", "true"]

            def one_process(name, nproc, group):
                # the plain process also restores (vi)'s checkpoint, training nothing, and runs (viii)'s flow
                plain = [{"name": "fsdp_restore", "restore": os.path.join(tmp, "fsdp"), "config": fsdp_cfg,
                          "argv": dev},
                         {"name": "ep_sp_one", "argv": ["--config", ep_sp_one_cfg, *dev], "deterministic": True,
                          "no_save": True}] if nproc is None else []
                return run_ranks(nproc, [
                    {"name": "resume", "argv": ["--config", zero_cfg, *resume, *group, *dev], "deterministic": True,
                     "no_save": True}, *plain,
                ], os.path.join(tmp, name), timeout=600)[0]

            with ThreadPoolExecutor(2) as pool:
                futures = {name: pool.submit(one_process, name, nproc, group) for name, nproc, group in (
                    ("nccl", 1, ["--dist_backend", "nccl" if cuda else "gloo"]), ("plain", None, []))}
                one = {name: f.result() for name, f in futures.items()}
    out["ddp_tiny"] = check_ddp_tiny([r["tiny"] for r in two], device)
    base, zero, scst, fsdp, tp, ep_sp, pp = ([r[k] for r in two]
                                             for k in ("base", "zero", "scst", "fsdp", "tp", "ep_sp", "pp"))
    check_ddp_base(base, short, val_batch, n_val, device, ckpts["base"])
    zero_err = check_ddp_zero(zero, base, short, device, ckpts["zero"])
    check_ddp_scst(scst, steps, device)
    fsdp_err = check_ddp_fsdp(fsdp, base, short, device, ckpts["fsdp"], one["plain"]["fsdp_restore"]["digest"])
    tp_err = check_ddp_tp(tp, base, short, val_batch, n_val, device, ckpts["tp"])
    ep_sp_one = one["plain"]["ep_sp_one"]
    ep_sp_err = check_ddp_ep_sp(ep_sp, ep_sp_one, short, val_batch, n_val, device, ckpts["ep_sp"])
    pp_err = check_ddp_pp(pp, base, short, val_batch, n_val, device, ckpts["pp"])
    n0, p0 = one["nccl"]["resume"], one["plain"]["resume"]
    if (n0["world"], len(n0["allreduce_ms"]), p0["allreduce_ms"]) != (1, n0["steps"], []) \
            or n0["losses"].keys() != p0["losses"].keys() or not _finite(n0["losses"]):
        raise AssertionError(f"phase f (iii): {n0['backend']} at {n0['world']} ranks, {len(n0['allreduce_ms'])} "
                             f"all-reduces, losses {n0['losses']} against {p0['losses']}")
    nccl_err = max(abs(x - y) for k in p0["losses"] for x, y in zip(n0["losses"][k], p0["losses"][k]))
    if nccl_err > NCCL_TOL:
        raise AssertionError(f"phase f (iii): NCCL losses differ from one process's by {nccl_err}")
    if n0["layernorm_launches_fwd_bwd"] != [n0["ln_per_step"] * n0["steps"] * cuda] * 2:
        raise AssertionError(f"phase f (iii) launches {n0['layernorm_launches_fwd_bwd']}")
    for r in (n0, p0):
        if r["restored_digests"] != [zero[0]["digest"]] or r["steps"] != steps or r["first_micro_step"] != short + 1:
            raise AssertionError(f"phase f (v): a resume at one process restored another state than the two "
                                 f"ZeRO ranks saved, or ran {r['steps']} steps from {r['first_micro_step']}")
    if (n0["zero_world"], p0["zero_world"], sorted(n0["collectives"])) != (0, 0, ["all_reduce_mean_"]):
        raise AssertionError(f"phase f (iii): ZeRO over {n0['zero_world']} and {p0['zero_world']} ranks, "
                             f"collectives {sorted(n0['collectives'])} (one rank is the replicated optimizer)")
    b0, z0, s0 = base[0], zero[0], scst[0]
    out["ddp_train"] = dict(_launch_summary(base), **{
        "config": "configs/pretrain-valor-base.json (first train flow)", "task": "pt (first flow)",
        "launch": f"python -m torch.distributed.run --standalone --nproc_per_node {DDP_WORLD} "
                  "-m valor_tpu_torch.cli.train ... --dist_backend gloo (through this script's --ddp-worker)",
        "ranks_on_one_card": DDP_WORLD, "global_batch": batch_size, "steps": short, "val_items": n_val,
        "deterministic": True, "samples_per_s_all": batch_size / float(np.median([r["median_step_s"] for r in base])),
        "samples_per_s_by_rank": [r["samples_per_s_rank"] for r in base],
        "median_step_s_by_rank": [r["median_step_s"] for r in base],
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in base],
        "allreduce_ms_by_rank": [r["allreduce_ms"] for r in base], "allreduce_bytes_a_step": b0["allreduce_bytes"][0],
        "params": b0["param_bytes_fp32"] // 4, "optimizer_state_bytes_by_rank": [r["optimizer_state_bytes"] for r in base],
        "ln_per_step": b0["ln_per_step"], "phase18_ln_per_step": (pt or {}).get("ln_per_step"),
        "validate_pt_s_by_rank": [r["validations"][0]["seconds"] for r in base],
        "report": b0["validations"][0]["report"], "losses": b0["losses"], "dataset_written_s": written_s})
    out["ddp_zero_train"] = dict(_launch_summary(zero), **zero_err, **{
        "config": "phase f (ii)'s, --zero_optimizer true --async_checkpoint true", "steps": short,
        "losses": z0["losses"], "replicated_losses": b0["losses"],
        "optimizer_state_bytes_by_rank": [r["optimizer_state_bytes"] for r in zero],
        "replicated_optimizer_state_bytes": b0["optimizer_state_bytes"],
        "replicated_moment_bytes_valor_base": REPLICATED_MOMENT_BYTES,
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in zero],
        "replicated_max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in base],
        "median_step_s_by_rank": [r["median_step_s"] for r in zero],
        "collectives_by_rank": [r["collectives"] for r in zero],
        "resume_losses_nccl": n0["losses"], "resume_losses_plain": p0["losses"],
        "resume_max_abs_loss_err": nccl_err, "resume_restored_equals_saved": True})
    out["ddp_scst_train"] = dict(_launch_summary(scst), **{
        "config": "configs/caption-msrvtt.json --scst_finetuning true (phase 15's run)", "steps": steps,
        "global_batch": batch_size, "max_len": s0.get("max_len"), "losses": s0["losses"], "alpha": s0["alpha"],
        "mean_reward_by_call": [float(np.mean(x)) for x in s0["rewards"]],
        "step_s_by_rank": [r["step_s"] for r in scst], "scst_parts_s_by_rank": [r["scst_parts_s"] for r in scst],
        "gather_ms_by_rank": [r["collectives"].get("all_gather_rows", {}).get("ms") for r in scst],
        "allreduce_ms_by_rank": [r["allreduce_ms"] for r in scst],
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in scst]})
    out["ddp_nccl_train"] = dict(_launch_summary([n0]), **{
        "launch": "python -m torch.distributed.run --standalone --nproc_per_node 1 -m valor_tpu_torch.cli.train "
                  "... --dist_backend nccl (through this script's --ddp-worker)",
        "start": "(v)'s checkpoint, --resume true --zero_optimizer true",
        "steps": steps, "batch": batch_size, "max_abs_loss_err": nccl_err, "tolerance": NCCL_TOL,
        "losses": n0["losses"], "allreduce_ms": n0["allreduce_ms"],
        "allreduce_ms_median": float(np.median(n0["allreduce_ms"])), "allreduce_bytes_a_step": n0["allreduce_bytes"][0],
        "samples_per_s": n0["samples_per_s_global"], "plain_samples_per_s": p0["samples_per_s_global"],
        "max_memory_allocated_gib": n0["max_memory_allocated_gib"],
        "plain_max_memory_allocated_gib": p0["max_memory_allocated_gib"], "collectives": n0["collectives"]})
    f0, t0_ = fsdp[0], tp[0]
    out["ddp_fsdp_train"] = dict(_launch_summary(fsdp), **fsdp_err, **{
        "config": "phase f (ii)'s without validation, --fsdp true (data 2 x model 1)", "steps": short,
        "global_batch": batch_size, "deterministic": True, "losses": f0["losses"], "replicated_losses": b0["losses"],
        "split_leaves": f0["data_split_leaves"],
        "param_bytes_by_rank": [r["param_bytes_fp32"] for r in fsdp], "replicated_param_bytes": b0["param_bytes_fp32"],
        "grad_bytes_by_rank": [r["grad_bytes"] for r in fsdp], "replicated_grad_bytes": b0["grad_bytes"],
        "optimizer_state_bytes_by_rank": [r["optimizer_state_bytes"] for r in fsdp],
        "replicated_optimizer_state_bytes": b0["optimizer_state_bytes"],
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in fsdp],
        "replicated_max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in base],
        "median_step_s_by_rank": [r["median_step_s"] for r in fsdp], "step_s_by_rank": [r["step_s"] for r in fsdp],
        "collectives_by_step_by_rank": [{k: v for k, v in r["collectives_by_step"].items()
                                         if k in ("all_gather_dim", "reduce_scatter_dim", "all_reduce_mean_")}
                                        for r in fsdp],
        "checkpoint": ckpts["fsdp"], "plain_process_restore_digest_equal": True})
    out["ddp_tp_train"] = dict(_launch_summary(tp), **tp_err, **{
        "config": f"phase f (ii)'s, --model_shards {DDP_WORLD} (data 1 x model {DDP_WORLD}), global batch "
                  f"{batch_size} on every rank", "steps": short, "deterministic": True,
        "losses": t0_["losses"], "replicated_losses": b0["losses"],
        "model_split_leaves": t0_["model_split_leaves"],
        "param_bytes_by_rank": [r["param_bytes_fp32"] for r in tp], "replicated_param_bytes": b0["param_bytes_fp32"],
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in tp],
        "median_step_s_by_rank": [r["median_step_s"] for r in tp], "step_s_by_rank": [r["step_s"] for r in tp],
        "model_all_reduce_by_step_by_rank": [r["collectives_by_step"].get("model_all_reduce_") for r in tp],
        "validate_pt_s_by_rank": [r["validations"][0]["seconds"] for r in tp],
        "report": t0_["validations"][0]["report"], "replicated_report": b0["validations"][0]["report"]})
    e0 = ep_sp[0]
    out["ddp_ep_sp_train"] = dict(_launch_summary(ep_sp), **ep_sp_err, **{
        "config": f"configs/pretrain-valor-base-moe.json (first train flow), --model_shards {DDP_WORLD} "
                  f"--sequence_parallel true (data 1 x model {DDP_WORLD}), global batch {batch_size} on every rank",
        "steps": short, "deterministic": True, "fusion_len": e0["fusion_len"],
        "losses": e0["losses"], "one_process_losses": ep_sp_one["losses"],
        "expert_split_forwards_by_rank": [r["expert_sharding_applied"] for r in ep_sp],
        "sequence_split_forwards_by_rank": [r["sequence_sharding_applied"] for r in ep_sp],
        "model_split_leaves": e0["model_split_leaves"],
        "param_bytes_by_rank": [r["param_bytes_fp32"] for r in ep_sp], "one_process_param_bytes": ep_sp_one["param_bytes_fp32"],
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in ep_sp],
        "one_process_max_memory_allocated_gib": ep_sp_one["max_memory_allocated_gib"],
        "median_step_s_by_rank": [r["median_step_s"] for r in ep_sp], "step_s_by_rank": [r["step_s"] for r in ep_sp],
        "one_process_median_step_s": ep_sp_one["median_step_s"],
        "model_collectives_by_step_by_rank": [{k: r["collectives_by_step"].get(k) for k in MODEL_COLLECTIVES}
                                              for r in ep_sp],
        "validate_pt_s_by_rank": [r["validations"][0]["seconds"] for r in ep_sp],
        "report": e0["validations"][0]["report"]})
    q0 = pp[0]
    out["ddp_pp_train"] = dict(_launch_summary(pp), **pp_err, **{
        "config": f"phase f (ii)'s, --fusion_pipeline_stages {DDP_WORLD} (data 1 x pipe {DDP_WORLD}: "
                  f"{batch_size // DDP_WORLD} rows a rank at the towers, the fusion stack's {q0['fusion_layers']} "
                  f"layers in {DDP_WORLD} stages, {q0['microbatches']} microbatches of "
                  f"{batch_size // q0['microbatches']})",
        "steps": short, "deterministic": True, "transport": q0["transport"],
        "losses": q0["losses"], "replicated_losses": b0["losses"],
        "pipelined_passes_by_rank": [r["pipeline_applied"] for r in pp],
        "stage_sends_a_step_by_rank": [r["pipe_stats"]["sends"] / short for r in pp],
        "stage_send_bytes_a_step_by_rank": [r["pipe_stats"]["send_bytes"] / short for r in pp],
        "stage_send_ms_a_step_by_rank": [1e3 * r["pipe_stats"]["send_s"] / short for r in pp],
        "pipe_gathers_a_step_by_rank": [r["pipe_stats"]["gathers"] / short for r in pp],
        "pipe_gather_bytes_a_step_by_rank": [r["pipe_stats"]["gather_bytes"] / short for r in pp],
        "pipe_gather_ms_a_step_by_rank": [1e3 * r["pipe_stats"]["gather_s"] / short for r in pp],
        "hand_backs_a_step_by_rank": [r["pipe_stats"]["hand_backs"] / short for r in pp],
        "hand_back_bytes_a_step_by_rank": [r["pipe_stats"]["hand_back_bytes"] / short for r in pp],
        "hand_back_ms_a_step_by_rank": [1e3 * r["pipe_stats"]["hand_back_s"] / short for r in pp],
        "bubble_by_rank": [r["bubble"] for r in pp], "bubble_ideal": (DDP_WORLD - 1) / (q0["microbatches"] + DDP_WORLD - 1),
        "schedule_s_by_rank": [r["pipe_timing"] for r in pp],
        "max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in pp],
        "replicated_max_memory_allocated_gib_by_rank": [r["max_memory_allocated_gib"] for r in base],
        "median_step_s_by_rank": [r["median_step_s"] for r in pp], "step_s_by_rank": [r["step_s"] for r in pp],
        "replicated_median_step_s_by_rank": [r["median_step_s"] for r in base],
        "allreduce_ms_by_rank": [r["allreduce_ms"] for r in pp],
        "ln_per_step_by_rank": [r["ln_per_step_pipelined"] for r in pp],
        "validate_pt_s_by_rank": [r["validations"][0]["seconds"] for r in pp],
        "report": q0["validations"][0]["report"]})
    out["seconds"] = time.monotonic() - t0
    for k, v in out.items():
        if isinstance(v, dict) and k != "ddp_tiny":
            log(f"{k} " + json.dumps({kk: vv for kk, vv in v.items() if not kk.endswith("_calls")}))
    log(f"phase f took {out['seconds']:.1f} s")
    return out


# -- phase 9 ------------------------------------------------------------------
def phase_path_shapes(paths, ln_rows, bwd_rows, fs_rows):
    """Every shape that the main paths (``paths``: the summaries of phases 4,
    8, 12, 14, 15, 16, 17 and 18) handed each kernel, held against its plain version:
    those that phases 2, 6 and 10 compared are listed as such, the others are
    compared here (on new seeded inputs, with the same tolerances, untimed)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for kind, sigs, rows in (
        ("fwd", [c for p in paths for c in p.get("layernorm_calls", [])], ln_rows),
        ("bwd", [c for p in paths for c in p.get("layernorm_bwd_calls", [])], bwd_rows),
    ):
        done = {tuple(r["sig"]) for r in rows}
        extra = []
        for n, c, eps, xd, od in sorted({tuple(s) for s in sigs}):
            if (n, c, eps, xd, od) in done:
                continue
            x, w, b = _ln_inputs(n, c, xd, gen)
            if kind == "fwd":
                err = check_fwd(x, w, b, eps, getattr(torch, od))[0]
            else:
                err = max(check_bwd(x, w, eps, torch.randn(
                    n, c, device="cuda", generator=gen).to(getattr(torch, od))))
            extra.append({"sig": [n, c, eps, xd, od], "max_abs_err": err})
            done.add((n, c, eps, xd, od))
        out[kind] = {"path_shapes": len({tuple(s) for s in sigs}), "compared_here": extra}
    done = {tuple(r["sig"]) for r in fs_rows}
    sigs = {tuple(s) for p in paths for s in p.get("fine_score_calls", [])}
    extra = [{"sig": list(s), "max_abs_err": check_fine(
        _fs_inputs(*s[:5], getattr(torch, s[5]), gen), f"fine_score path shape {s}")}
             for s in sorted(sigs - done)]
    out["fine_score"] = {"path_shapes": len(sigs), "compared_here": extra}
    log("path shapes " + json.dumps(out))
    return out


def phase18_alone() -> None:
    """Phases 1, 8 and 18, and phase 14's dataset written for phase 18."""
    import torch

    from valor_tpu_torch.data.synthetic import write_retrieval_dataset

    phase_card_and_build()
    pretrain = phase_pretrain()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="valor_smoke_") as tmp:
        paths = write_retrieval_dataset(os.path.join(tmp, "data"), n_train=320, n_val=128)
        phase_cli_pt_prompts(paths, synthetic=pretrain)


def families_alone() -> None:
    """Phases 1 and a-e, on phase 14's and phase 15's datasets written for
    them (no earlier training run on them), then phase 9 over every shape
    that they handed the kernels."""
    import torch

    from valor_tpu_torch.data.synthetic import write_caption_dataset, write_retrieval_dataset

    phase_card_and_build()
    with tempfile.TemporaryDirectory(prefix="valor_smoke_") as tmp:
        ret = write_retrieval_dataset(os.path.join(tmp, "ret"), n_train=320, n_val=128)
        cap = write_caption_dataset(os.path.join(tmp, "cap"), 320, 128)
        paths = phases_families(ret, cap)
    torch.cuda.empty_cache()
    phase_path_shapes([v for k, v in paths.items() if k != "families_card_vs_cpu"], [], [], [])


def ddp_alone() -> None:
    """Phases 1 and f alone, on a caption dataset of phase 15's shape (64
    training and 8 evaluation ids) and a caption run of the sharp init law's
    weights (``data/synthetic.py:write_sharp_init_run``) written for phase f (iv),
    then phase 9 over every shape that phase f's paths handed the kernels."""
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.data.synthetic import write_caption_dataset, write_sharp_init_run

    phase_card_and_build()
    with tempfile.TemporaryDirectory(prefix="valor_smoke_") as tmp:
        cap = write_caption_dataset(os.path.join(tmp, "cap"), 64, 8)
        run = write_sharp_init_run(os.path.join(tmp, "cap_run"),
                             load_config(str(ROOT / "configs" / "caption-msrvtt.json")).model)
        ddp = phase_ddp(cap, run)
    phase_path_shapes([v for k, v in ddp.items() if k not in ("ddp_tiny", "seconds")], [], [], [])


def tp_dtypes_alone(steps: int = 3, batch_size: int = 16) -> None:
    """Phase f (ii) and (vii) alone, without validation, at ``batch_size``
    (half phase f's, so that fp32 activations of two ranks fit the card), each
    with ``dtype`` float32 and bfloat16, under deterministic algorithms; logs
    each flow's losses, peak and median step."""
    from valor_tpu_torch.data.synthetic import write_retrieval_dataset

    phase_card_and_build()
    with tempfile.TemporaryDirectory(prefix="valor_tp_dtypes_") as tmp:
        data = write_retrieval_dataset(os.path.join(tmp, "data"), n_train=steps * batch_size, n_val=16, n_frames=4,
                                       wav_seconds=4.0, captions_per_train_id=1)

        def config(name, dtype):
            return cli_config(data, tmp, "pretrain-valor-base.json", name, lambda raw: first_pt_flow(
                raw, data, os.path.join(tmp, name), steps, batch_size, None, False, {"dtype": dtype}))

        gloo = ["--dist_backend", "gloo"]
        flows = [{"name": f"{kind}_{dt}", "argv": ["--config", config(f"{kind}_{dt}", dt), *extra, *gloo],
                  "deterministic": True, "no_save": True}
                 for dt in ("float32", "bfloat16")
                 for kind, extra in (("replicated", []), ("tp", ["--model_shards", str(DDP_WORLD)]))]
        with env_for(data):
            ranks = run_ranks(DDP_WORLD, flows, os.path.join(tmp, "two"), timeout=900)
    for f in flows:
        r = ranks[0][f["name"]]
        log(f"{f['name']} " + json.dumps({"losses": r["losses"], "max_memory_allocated_gib": r["max_memory_allocated_gib"],
                                          "median_step_s": r["median_step_s"], "grid": r["grid"]}))


def main(argv=None) -> int:
    import torch

    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--ddp-worker"] and len(args) == 3:
        return ddp_worker(args[1], args[2])
    if args not in ([], ["--phase18"], ["--families"], ["--ddp"], ["--tp-dtypes"]):
        print("usage: python3 chip_smoke.py [--phase18 | --families | --ddp | --tp-dtypes]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args == ["--phase18"]:
        phase18_alone()
        return 0
    if args == ["--families"]:
        families_alone()
        return 0
    if args == ["--ddp"]:
        ddp_alone()
        return 0
    if args == ["--tp-dtypes"]:
        tp_dtypes_alone()
        return 0
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import init_params, load_model

    smi = phase_card_and_build()
    ln_rows = phase_layernorm()
    phase_card_vs_cpu()

    cfg = load_config(str(ROOT / "configs" / "caption-valor32k.json")).model
    t0 = time.monotonic()
    model = load_model(cfg, init_params(cfg, seed=0, device="cuda"), "cuda")
    log(f"VALOR-base ({cfg.dtype}, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params) "
        f"built in {time.monotonic() - t0:.1f} s")
    serving = phase_serving(model, cfg)
    phase_http(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()

    bwd_rows = phase_layernorm_bwd()
    phase_train_card_vs_cpu()
    pretrain = phase_pretrain()
    gc.collect()
    torch.cuda.empty_cache()

    fs_rows = phase_fine_score()
    phase_ret_card_vs_cpu()
    retrieval = phase_retrieval()
    gc.collect()
    torch.cuda.empty_cache()

    phase_resume_tiny()
    # phase 14's dataset stays for phase 18, phase 15's dataset and run for phase 17
    work = tempfile.TemporaryDirectory(prefix="valor_smoke_")
    try:
        cli = phase_cli_train(synthetic=retrieval, root=os.path.join(work.name, "ret"))
        gc.collect()
        torch.cuda.empty_cache()

        phase_cap_qa_card_vs_cpu()
        cap, qa = phase_cap_qa_from_disk(synthetic=cli, root=os.path.join(work.name, "cap_qa"))
        gc.collect()
        torch.cuda.empty_cache()

        phase_scst_prompt_card_vs_cpu()
        scst = phase_cli_scst(cap["paths"], cap["output_dir"], steps=6, synthetic=cap)
        gc.collect()
        torch.cuda.empty_cache()
        pt = phase_cli_pt_prompts(cli["paths"], synthetic=pretrain)
        gc.collect()
        torch.cuda.empty_cache()
        infer = phase_extract_infer(cap["paths"], cap["output_dir"], root=os.path.join(work.name, "video"))
        serve_video = phase_serve_video(cap["paths"], cap["output_dir"], infer["clip_paths"])
        weights = phase_weights_in(cap["paths"])
        gc.collect()
        torch.cuda.empty_cache()
        ddp = phase_ddp(cap["paths"], cap["output_dir"], pt)
        shutil.rmtree(cap["output_dir"])
        families = phases_families(cli["paths"], cap["paths"], pt)
        gc.collect()
        torch.cuda.empty_cache()
        phase_decoder(cli["paths"])
    finally:
        work.cleanup()
    family_paths = {k: v for k, v in families.items() if k != "families_card_vs_cpu"}
    ddp_paths = {k: v for k, v in ddp.items() if k not in ("ddp_tiny", "seconds")}
    shapes = phase_path_shapes([serving, pretrain, retrieval, cli, cap, qa, scst, infer, serve_video, weights, pt,
                                *family_paths.values(), *ddp_paths.values()], ln_rows, bwd_rows, fs_rows)

    fwd_row, bwd_row = ln_rows[0], bwd_rows[0]  # the ViT shape in bf16: the largest on both paths
    fs_row = fs_rows[0]  # MSR-VTT tva in fp32: the eval path's first group
    trained = {"pretraining": pretrain, "retrieval": retrieval, "cli_train": cli, "cap_train": cap,
               "qa_train": qa, "scst_train": scst, "infer": infer, "weights_train": weights,
               "pt_prompt_train": pt, **{k: v for k, v in family_paths.items() if k != "gqa_serving"},
               **ddp_paths}
    served = {"serving": serving, "serve_video": serve_video, "gqa_serving": family_paths["gqa_serving"]}
    by_path = dict(**{k: v["layernorm_launches"] for k, v in served.items()},
                   **{k: v["layernorm_launches_fwd_bwd"][0] for k, v in trained.items()})
    bwd_by_path = dict(**{k: 0 for k in served}, **{k: v["layernorm_launches_fwd_bwd"][1] for k, v in trained.items()})
    fs_by_path = dict(**{k: 0 for k in served}, **{k: v.get("fine_score_launches", 0) for k, v in trained.items()})
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": [{
        "name": "layernorm_fwd", "route": "cuda",
        "source": "valor_tpu_torch/csrc/layernorm.cu",
        "replaces": "valor_tpu/ops/pallas/layernorm.py:34",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in ln_rows + shapes["fwd"]["compared_here"]),
        "ms": fwd_row["kernel_ms"], "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"], "bound_by": "bytes",
        "library_ms": fwd_row["library_ms"], "shape": fwd_row["shape"],
    }, {
        "name": "layernorm_bwd", "route": "cuda",
        "source": "valor_tpu_torch/csrc/layernorm.cu",
        "replaces": "valor_tpu/ops/pallas/layernorm.py:45",
        "launches": sum(bwd_by_path.values()), "launches_by_path": bwd_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows + shapes["bwd"]["compared_here"]),
        "ms": bwd_row["kernel_ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": "bytes",
        "library_ms": bwd_row["library_ms"], "shape": bwd_row["shape"],
    }, {
        "name": "fine_score", "route": "cuda",
        "source": "valor_tpu_torch/csrc/fine_score.cu",
        "replaces": "valor_tpu/ops/pallas/fine_score.py:43",
        "launches": sum(fs_by_path.values()), "launches_by_path": fs_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in fs_rows + shapes["fine_score"]["compared_here"]),
        "ms": fs_row["kernel_ms"], "plain_ms": fs_row["plain_ms"],
        "bound_ms": fs_row["bound_ms"], "bound_by": fs_row["bound_by"],
        "library_ms": None, "gemm_ms": fs_row["gemm_ms"], "shape": fs_row["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
