"""Training loop of the port (counterpart of ``valor_tpu/train/trainer.py``).

``Trainer.run`` walks a list or an iterator of ``(task, batch)`` pairs, one
``train_step`` each, until ``num_train_steps`` optimizer updates are made or
the pairs run out.  Steps are counted per optimizer update, as the reference
counts its global step: with gradient accumulation k, k micro-batches make one
step.  Per-task ``RunningMeter``s see every step's losses; the loop reads the
device once per log interval (every 100 steps), not once per step.  Batches
are dicts of numpy arrays or tensors in the collate layout; host-only keys are
dropped and the rest moved to the model's device.  With ``prefetch`` (the
default, ``TrainConfig.prefetch``) an iterator of pairs, such as a
``MetaLoader``, goes through ``data.loader.DevicePrefetcher``: one batch in
flight to the card, copied on a side stream while the step runs; a list of
pairs is moved step by step.  A resumed state starts at its ``step``, counted
in micro-batches.  At each log point the meters go to ``TB_LOGGER`` too, with
the data-stall share (host time blocked on the input pipeline over the
window); ``data_wait_s`` keeps that host time over the whole run.  With MoE
fusion layers (``fusion_moe_experts`` > 0) every step's losses carry
``moe_aux``, weighted by ``fusion_moe_aux_weight``.  Across processes every
rank runs this loop on its shard of each global batch: as many steps on every
rank (the loaders' shards yield as many batches), the global batch's losses in
the meters, the same update on every rank (``train/step.py``), the same
validation reports; rank 0 logs and writes the checkpoints.

SCST finetuning (``scst_finetuning`` on a ``cap`` task; reference
model/pretrain.py:741-791) runs ``scst_step`` in place of ``train_step``: the
media encoded once without autograd, for each caption group a greedy
(baseline) and a sampled rollout, the host CIDEr+BLEU reward of both
(``eval/scorer.py``), the advantage sample - alpha * greedy, and one REINFORCE
update (``train/step.py:scst_update``).  ``train_inner_steps`` (steps fused
into one compiled call on a TPU) is read and ignored.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

import numpy as np

from valor_tpu_torch.core.config import Config
from valor_tpu_torch.core.logging import LOGGER, TB_LOGGER, RunningMeter
from valor_tpu_torch.core.tasks import TaskSpec, parse_task
from valor_tpu_torch.data.loader import DevicePrefetcher
from valor_tpu_torch.eval.generate import Generator, _decode
from valor_tpu_torch.eval.scorer import AdaptiveAlpha, Scorer
from valor_tpu_torch.eval.validate import eval_mode
from valor_tpu_torch.models.valor import EOS_TOKEN
from valor_tpu_torch.ops.layers import _mix
from valor_tpu_torch.parallel import collectives as C
from valor_tpu_torch.parallel.fsdp import unsharded
from valor_tpu_torch.parallel.mesh import batch_shard, step_shard
from valor_tpu_torch.train.step import (
    TrainState, moe_aux_weight_for, scst_update, to_device, train_step,
)


class Trainer:
    """``validate_fn(model, step) -> {name: report}`` and ``saver.save(state,
    step, best_name=...)`` / ``saver.finish()`` may be None.  ``step_hook(step,
    task_name, metrics)`` is called after every micro-step with that step's
    device metrics (a measurement hook; None by default).  SCST needs
    ``scorer``, the reward over the training annotations."""

    def __init__(
        self,
        cfg: Config,
        state: TrainState,
        meta_loader,
        *,
        validate_fn: Optional[Callable[[Any, int], Dict[str, Dict[str, float]]]] = None,
        saver=None,
        step_hook: Optional[Callable[[int, str, Dict[str, torch.Tensor]], None]] = None,
        prefetch: bool = True,
        scorer: Optional[Scorer] = None,
    ):
        self.cfg = cfg
        self.state = state
        self.device = next(state.model.parameters()).device
        if prefetch and meta_loader is not None and not isinstance(meta_loader, list):
            meta_loader = DevicePrefetcher(meta_loader, self.device)
        self.meta_loader = meta_loader
        self.validate_fn = validate_fn
        self.saver = saver
        self.step_hook = step_hook
        self.data_wait_s = 0.0  # host time blocked on the input pipeline, whole run
        self.meters: Dict[str, RunningMeter] = {}
        self.best: Dict[str, float] = {}
        # (micro-step, task, {metric: float}) of the last 10000 steps, read at log points
        self.history: collections.deque = collections.deque(maxlen=10000)
        self._task_cache: Dict[str, TaskSpec] = {}
        self._pending: list = []
        self.scorer = scorer
        self.alpha = AdaptiveAlpha()
        self.moe_aux_weight = moe_aux_weight_for(cfg.model)

    def _meter(self, name: str) -> RunningMeter:
        if name not in self.meters:
            self.meters[name] = RunningMeter(name)
        return self.meters[name]

    def _spec(self, task: str) -> TaskSpec:
        if task not in self._task_cache:
            self._task_cache[task] = parse_task(task)
        return self._task_cache[task]

    def _drain_metrics(self) -> None:
        """One device read for every step since the last one."""
        if not self._pending:
            return
        keys = [(m, t, list(d)) for m, t, d in self._pending]
        flat = torch.stack([v.float() for _, _, d in self._pending for v in d.values()]).tolist()
        i = 0
        for micro, task_name, names in keys:
            vals = dict(zip(names, flat[i : i + len(names)]))
            i += len(names)
            self.history.append((micro, task_name, vals))
            for k, v in vals.items():
                self._meter(f"{task_name}/{k}")(v)
        self._pending = []

    def run(self) -> TrainState:
        t = self.cfg.train
        accum = max(t.gradient_accumulation_steps, 1)
        micro = self.state.step
        step = micro // accum
        last_logged = last_evaled = step
        t_start = t_window = time.time()
        data_wait = 0.0  # host time blocked on the input pipeline
        loader_it = iter(self.meta_loader)
        while True:
            t0 = time.perf_counter()
            item = next(loader_it, None)
            waited = time.perf_counter() - t0
            data_wait += waited
            self.data_wait_s += waited
            if item is None or step >= t.num_train_steps:
                break
            task_name, batch = item
            spec = self._spec(task_name.split("--")[0])
            if self.cfg.model.scst_finetuning and spec.family == "cap":
                metrics = self.scst_step(to_device(batch, self.device), batch.get("ids"), spec)
            else:
                metrics = train_step(self.state, to_device(batch, self.device), spec, t.seed,
                                     grad_dtype=t.grad_dtype, moe_aux_weight=self.moe_aux_weight)
            micro += 1
            self._pending.append((micro, task_name, metrics))
            if self.step_hook is not None:
                self.step_hook(micro, task_name, metrics)
            step = micro // accum
            if step // 100 > last_logged // 100:
                last_logged = step
                self._drain_metrics()
                now = time.time()
                window = max(now - t_window, 1e-9)
                stall = data_wait / window
                t_window, data_wait = now, 0.0
                ms = {k: m.val for k, m in self.meters.items() if m.val is not None}
                LOGGER.info(
                    f"step {step}/{t.num_train_steps} "
                    f"({step / max(now - t_start, 1e-9):.2f} it/s, data_stall={stall:.1%}) "
                    + " ".join(f"{k}={v:.4f}" for k, v in ms.items()))
                TB_LOGGER.set_step(step)
                ms["data_stall"] = stall
                TB_LOGGER.log_scalar_dict(ms)
            if t.valid_steps and step // t.valid_steps > last_evaled // t.valid_steps:
                last_evaled = step
                self._drain_metrics()
                self.evaluate_and_save(step)
            if step >= t.num_train_steps:
                break
        self._drain_metrics()
        self.evaluate_and_save(micro // accum)
        if self.saver is not None:
            self.saver.finish()
        return self.state

    def evaluate_and_save(self, step: int) -> None:
        best_name = None
        if self.validate_fn is not None:
            for val_name, report in self.validate_fn(self.state.model, step).items():
                LOGGER.info(f"eval {val_name} @ {step}: {report}")
                for metric in ("ravg", "CIDEr", "accuracy"):
                    if metric in report:
                        key = f"{val_name}/{metric}"
                        if report[metric] > self.best.get(key, -1e9):
                            self.best[key] = report[metric]
                            if self.cfg.train.save_best:
                                best_name = val_name
        if self.saver is not None:
            self.saver.save(self.state, step, best_name=best_name)

    def scst_step(self, batch: Dict[str, torch.Tensor], ids, spec: TaskSpec) -> Dict[str, torch.Tensor]:
        """One SCST batch (``valor_tpu/train/trainer.py:scst_step``): the media
        encoded once, without dropout and without autograd; then for each
        caption group a greedy and a sampled rollout of ``max_generation_len``
        tokens, the reward of both on the host (the two device-to-host copies
        the step needs), ``AdaptiveAlpha.update``, the advantage sample - alpha
        * greedy and one REINFORCE update, which advances ``state.step``.  The
        sampled rollouts of every group draw from one seed, from
        ``train.seed`` and the step, on the decode's device (as the JAX step
        uses one key for every group).  Returns ``scst_reward_{g}`` (the mean
        sampled reward) and ``caption_loss_{g}`` as device scalars.

        Across processes each rank decodes its rows of the global batch, its
        sampled rollout drawing its rows of the global batch's uniforms; the
        ids and both rollouts are gathered in the global batch's order, every
        rank rewards the whole batch and updates ``AdaptiveAlpha`` on it (so
        every rank holds the same alpha), and the update's loss is normalised
        over the global batch with its gradients averaged over ranks
        (``train/step.py:scst_update``): W ranks make one process's step.  On
        a (data, model, pipe) mesh the rows, draws and gathers are the batch
        axis's, so the model ranks of one data rank sample the same tokens;
        the rollouts read ``fsdp``'s parameters gathered once
        (``parallel/fsdp.py:unsharded``) and decode the fusion stack whole,
        while the update's forward pipelines it over the pipe axis where
        there is one (its shard is a training step's)."""
        if self.scorer is None:
            raise ValueError("SCST needs a Scorer over the training annotations")
        c = self.cfg.model
        model = self.state.model
        generator = Generator(model)
        with torch.no_grad(), eval_mode(model), unsharded(model):
            video_input, audio_input = generator.encode(batch, spec.caption_groups)
        prompt = batch.get("prompt_tokens_caption")
        seed = _mix(self.cfg.train.seed, self.state.step)
        shard = step_shard(batch)
        decode_shard = None if shard is None else dataclasses.replace(shard, collective=False)
        metrics: Dict[str, torch.Tensor] = {}
        for g in spec.caption_groups:
            v = video_input if "v" in g else None
            a = audio_input if "a" in g else None
            sampler = torch.Generator(device=self.device).manual_seed(seed)
            with torch.no_grad(), eval_mode(model), batch_shard(decode_shard), unsharded(model):
                seq_g, _ = _decode(model, c.caption_type, c.max_generation_len, 1, "greedy",
                                   prompt, v, a, None)
                seq_s, _ = _decode(model, c.caption_type, c.max_generation_len, 1, "sample",
                                   prompt, v, a, sampler)
            rows = C.all_gather_rows(list(zip(ids, seq_g.cpu().numpy(), seq_s.cpu().numpy())), shard)
            all_ids = [r[0] for r in rows]
            r_greedy = self.scorer(all_ids, [_strip(r[1]) for r in rows])
            r_sample = self.scorer(all_ids, [_strip(r[2]) for r in rows])
            self.alpha.update(r_sample, r_greedy)
            advantage = r_sample - r_greedy * self.alpha.value()
            mine = advantage if shard is None else advantage[shard.index]
            rewards = torch.from_numpy(np.ascontiguousarray(mine)).to(self.device)
            scst_batch = {"video_input": v, "audio_input": a, "prompt_tokens_caption": prompt}
            m = scst_update(self.state, scst_batch, seq_s, rewards, c.caption_type, g, shard)
            metrics[f"scst_reward_{g}"] = torch.tensor(float(np.mean(r_sample)), device=self.device)
            metrics[f"caption_loss_{g}"] = m["loss"]
        return metrics


def _strip(seq: np.ndarray) -> list:
    """The ids of a generated row before its first EOS."""
    out = []
    for t in seq.tolist():
        if t == EOS_TOKEN:
            break
        out.append(int(t))
    return out
