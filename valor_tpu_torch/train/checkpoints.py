"""Checkpoints of the port: save and restore with ``torch.save``, and load-time
surgery (counterpart of ``valor_tpu/train/checkpoints.py``).

``ModelSaver`` keeps the JAX package's layout and bookkeeping (reference
utils/save.py:32-64, train_utils.py:117-192): ``<output_dir>/ckpt/step_N``,
one directory a save, named by the optimizer step, holding ``state.pt``:
the model's ``state_dict`` ("params"), the optimizer's ``state_dict``
("opt_state": moments, counters and half-accumulated gradients), "step" and
"micro_step" (``TrainState.step``, the micro-batch counter, so a resume under
gradient accumulation restarts exactly where it stopped).  A save writes into
``step_N.tmp`` and renames it, so a crash mid-write leaves the previous
checkpoint whole; ``best_<name>`` copies the best one; with
``remove_before_ckpt`` the previous step's directory goes once the new one is
written.  Across processes rank 0 writes and every rank restores; every rank
first takes part in gathering whole to rank 0 what the mesh splits: the
parameters that tensor parallelism or ``fsdp`` place
(``parallel/partition.py:whole_state_dict``) and the optimizer state
(``GroupedAdam.state_dict``, ZeRO-1's blocks included), so a checkpoint has
one layout at any mesh, and ``load_state`` takes this rank's blocks of it.

``use_async`` (``TrainConfig.async_checkpoint``; the JAX package's orbax
AsyncCheckpointer): ``save`` returns once the state is snapshotted to host
memory, and a background thread writes it (``torch.save``, then the atomic
rename) while training goes on.  The snapshot copies every tensor into host
buffers allocated at the first save and reused (pinned on a card, where the
copy runs on a side stream after the work already queued; the optimizer's
next update waits for it, ``GroupedAdam.wait_before_update``, and the writer
thread for its event).  The bookkeeping (best copy, removal of the previous
step) waits until the write is durable: the next ``save``, ``finish``,
``latest_step`` and ``restore`` first wait for a pending write and run its
bookkeeping, so a crash mid-write never deletes the last good checkpoint.
Across processes every rank keeps the pending step and waits at a barrier in
``finish`` (rank 0 after its write), so every rank calls ``save`` and
``finish`` together, as they do.  Synchronous saves (the default) write as
before: rank 0 writes, every rank waits for it at a barrier.

Divergence, a fix: saving twice at one step (the trainer's periodic save at
the last step, then its final save) keeps the checkpoint.  The JAX package
removes the "previous" step's directory there, which is the one it just wrote.

Surgery (numpy, on flat ``state_dict``-style mappings): CLIP visual position
embeddings resized bilinearly for a new resolution (reference
train_utils.py:153-168, model/clip.py:481-491; the resize is
``jax.image.resize(method="bilinear")``'s, antialiased when it shrinks), and
frame-embedding rows extended by copying the last trained row or truncated
(train_utils.py:148-151).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from valor_tpu_torch.core.logging import LOGGER, is_main_process
from valor_tpu_torch.parallel.mesh import barrier
from valor_tpu_torch.parallel.partition import load_whole, whole_state_dict

STATE_FILE = "state.pt"


def _ckpt_dir(output_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(output_dir, "ckpt", f"step_{step}"))


class ModelSaver:
    """Checkpoint writer and reader of one output directory.  ``writes`` holds
    (step, host time the write began, host time it was durable), from
    ``time.perf_counter``, of every asynchronous write of rank 0."""

    def __init__(self, output_dir: str, remove_before_ckpt: bool = True, use_async: bool = False):
        self.output_dir = output_dir
        self.remove_before = remove_before_ckpt
        self.use_async = bool(use_async)
        self.last_step: Optional[int] = None
        self._pending: Optional[Tuple[int, Optional[str]]] = None  # (step, best_name) of the write in flight
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._host: Dict[str, torch.Tensor] = {}  # snapshot buffers, by payload path
        self._stream = None
        self.writes: List[Tuple[int, float, float]] = []
        os.makedirs(os.path.join(output_dir, "ckpt"), exist_ok=True)

    @staticmethod
    def _payload(state, step: int) -> Dict[str, Any]:
        return {
            "params": whole_state_dict(state.model),
            "opt_state": state.optimizer.state_dict(),
            "step": step,
            "micro_step": int(state.step),
        }

    def save(self, state, step: int, best_name: Optional[str] = None) -> None:
        """Write ``state`` (a ``train.step.TrainState``) as checkpoint ``step``:
        rank 0 writes (every rank holds the same state).  Synchronous: every
        rank waits for the write before it goes on.  Asynchronous: the
        previous write is waited for first, and this one runs in the
        background."""
        if not self.use_async:
            payload = self._payload(state, step)
            if is_main_process():
                self._write(payload, step, best_name)
            barrier()
            return
        self.finish()
        payload = self._payload(state, step)
        if is_main_process():
            host, event = self._snapshot(payload)
            if event is not None:
                state.optimizer.wait_before_update(event)
            self._thread = threading.Thread(target=self._commit, args=(host, step, event),
                                            name=f"checkpoint-step-{step}", daemon=True)
            self._thread.start()
        self._pending = (step, best_name)

    def _snapshot(self, payload):
        """``payload`` with every tensor copied into this saver's host buffers
        (allocated once, pinned for card tensors); and the CUDA event that
        marks the copies done (None where no tensor is on a card)."""
        device = next((t.device for t in _tensors(payload) if t.is_cuda), None)
        if device is None:
            return _map_tensors(payload, lambda path, t: self._buffer(path, t, False).copy_(t)), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(device))  # after every update already queued

        def copy(path, t):
            buf = self._buffer(path, t, t.is_cuda)
            if t.is_cuda:
                buf.copy_(t, non_blocking=True)
                t.record_stream(stream)  # a gathered ZeRO tensor may be freed before the copy is done
            else:
                buf.copy_(t)
            return buf

        with torch.cuda.stream(stream):
            host = _map_tensors(payload, copy)
            event = torch.cuda.Event()
            event.record(stream)
        return host, event

    def _buffer(self, path: str, t: torch.Tensor, pin: bool) -> torch.Tensor:
        buf = self._host.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            self._host[path] = buf
        return buf

    def _commit(self, host, step: int, event) -> None:
        t0 = time.perf_counter()
        try:
            if event is not None:
                event.synchronize()
            self._write(host, step, None, bookkeep=False)
        except BaseException as e:  # raised again by finish()
            self._error = e
        self.writes.append((step, t0, time.perf_counter()))

    def _write(self, payload, step: int, best_name: Optional[str], bookkeep: bool = True) -> None:
        path = _ckpt_dir(self.output_dir, step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        if bookkeep:
            self._bookkeep(step, best_name)

    def finish(self) -> None:
        """Wait until the write in flight (if any) is durable and run its
        bookkeeping; every rank then meets at a barrier.  Nothing to do after
        synchronous saves, or twice."""
        if self._pending is None:
            return
        step, best_name = self._pending
        self._pending = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError(f"writing checkpoint step {step} failed") from err
            self._bookkeep(step, best_name)
        else:
            self.last_step = step
        barrier()

    def _bookkeep(self, step: int, best_name: Optional[str]) -> None:
        path = _ckpt_dir(self.output_dir, step)
        if best_name:
            best_path = os.path.join(self.output_dir, "ckpt", f"best_{best_name}")
            if os.path.exists(best_path):
                shutil.rmtree(best_path)
            shutil.copytree(path, best_path)
        if self.remove_before and self.last_step is not None and self.last_step != step:
            prev = _ckpt_dir(self.output_dir, self.last_step)
            if os.path.exists(prev):
                shutil.rmtree(prev)
        self.last_step = step

    def latest_step(self) -> Optional[int]:
        self.finish()
        root = os.path.join(self.output_dir, "ckpt")
        if not os.path.isdir(root):
            return None
        steps = [int(m.group(1)) for d in os.listdir(root) if (m := re.match(r"step_(\d+)$", d))]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The payload of checkpoint ``step`` (the latest when None) on the
        CPU, or None when there is none (a write in flight is waited for)."""
        self.finish()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(_ckpt_dir(self.output_dir, step), STATE_FILE)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        LOGGER.info(f"restored checkpoint at step {step}")
        return payload


def _map_tensors(obj, fn, path: str = ""):
    """``obj`` (dicts, lists and leaves) with every tensor ``t`` at ``path``
    replaced by ``fn(path, t)``."""
    if isinstance(obj, torch.Tensor):
        return fn(path, obj)
    if isinstance(obj, dict):
        return type(obj)((k, _map_tensors(v, fn, f"{path}/{k}")) for k, v in obj.items())
    if isinstance(obj, list):
        return [_map_tensors(v, fn, f"{path}/{i}") for i, v in enumerate(obj)]
    return obj


def _tensors(obj) -> list:
    out: list = []
    _map_tensors(obj, lambda path, t: out.append(t))
    return out


def load_state(state, payload: Mapping[str, Any]) -> None:
    """Copy a restored payload into ``state``'s model and optimizer (keeping
    their devices and dtypes; this rank's blocks of a placed model) and set
    its micro-step counter."""
    load_whole(state.model, payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload.get("micro_step") or payload["step"])


# ---------------------------------------------------------------------------
# checkpoint surgery
# ---------------------------------------------------------------------------


def _bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of ``jax.image.resize``'s bilinear (triangle)
    kernel along one axis, antialiased: the kernel widens by n_in / n_out when
    it shrinks (jax/_src/image/scale.py:compute_weight_mat)."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_grid(img: np.ndarray, dst_hw) -> np.ndarray:
    """[h, w, c] -> [H, W, c] bilinear, as ``jax.image.resize``."""
    h, w, _ = img.shape
    out = img
    if h != dst_hw[0]:
        out = np.einsum("hwc,hH->Hwc", out, _bilinear_weights(h, dst_hw[0]))
    if w != dst_hw[1]:
        out = np.einsum("hwc,wW->hWc", out, _bilinear_weights(w, dst_hw[1]))
    return out.astype(np.float32)


def bilinear_resize_pos_embed(pos: np.ndarray, new_grid: int, has_cls: bool = True) -> np.ndarray:
    """[(1+)g*g, C] -> [(1+)G*G, C] bilinear over the spatial grid
    (reference: model/clip.py:481-491, modeling.py:520-527)."""
    pos = np.asarray(pos, np.float32)
    grid = pos[1:] if has_cls else pos
    g = int(round(len(grid) ** 0.5))
    return bilinear_resize_pos_embed_2d(pos, (g, g), (new_grid, new_grid), has_cls)


def bilinear_resize_pos_embed_2d(pos: np.ndarray, src_hw, dst_hw, has_cls: bool = True) -> np.ndarray:
    """Non-square variant for the AST pos-emb remap (modeling.py:520-527)."""
    pos = np.asarray(pos, np.float32)
    cls = pos[:1] if has_cls else None
    grid = pos[1:] if has_cls else pos
    c = grid.shape[-1]
    out = _resize_grid(grid.reshape(src_hw[0], src_hw[1], c), dst_hw)
    out = out.reshape(dst_hw[0] * dst_hw[1], c)
    return np.concatenate([cls, out], axis=0) if has_cls else out


def extend_frame_embedding(frame_emb: np.ndarray, n_needed: int) -> np.ndarray:
    """Copy the last trained row into rows beyond the pretrain frame count
    (reference: train_utils.py:148-151), or truncate to the first
    ``n_needed`` rows when finetuning with fewer frames than pretraining."""
    fe = np.asarray(frame_emb)
    n_have = fe.shape[1]
    if n_needed == n_have:
        return fe
    if n_needed < n_have:
        return fe[:, :n_needed]
    pad = np.repeat(fe[:, -1:], n_needed - n_have, axis=1)
    return np.concatenate([fe, pad], axis=1)


def adapt_pretrained_params(params: Mapping[str, Any], target: Mapping[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """Shape-adapt a loaded ``state_dict`` onto ``target``'s (name -> tensor):
    position-embedding resize for the CLIP vision tower, frame-embedding
    extension; everything else taken as it is where the shapes match and
    ``target``'s otherwise (strict=False load semantics, modeling.py:107-115).
    The result has ``target``'s dtypes and devices."""
    out: Dict[str, torch.Tensor] = {}
    missing, mismatched = [], []
    for key, dst in target.items():
        src = params.get(key)
        if src is None:
            missing.append(key)
            out[key] = dst
            continue
        src = src.detach().cpu().numpy() if isinstance(src, torch.Tensor) else np.asarray(src)
        if src.shape == tuple(dst.shape):
            new = src
        elif "positional_embedding" in key and src.ndim == 2 and "clip_vision" in key:
            new = bilinear_resize_pos_embed(src, int(round((dst.shape[0] - 1) ** 0.5)))
        elif "frame_embedding" in key and src.ndim == 3:
            new = extend_frame_embedding(src, dst.shape[1])
        else:
            mismatched.append(f"{key}: {src.shape} -> {tuple(dst.shape)}")
            out[key] = dst
            continue
        # reshape: np.ascontiguousarray makes a 0-d array (a temperature) 1-d
        out[key] = torch.as_tensor(np.ascontiguousarray(new)).reshape(dst.shape).to(dst.device, dst.dtype)
    if missing:
        LOGGER.info(f"missing keys (target-init): {missing[:20]}{'...' if len(missing) > 20 else ''}")
    if mismatched:
        LOGGER.info(f"shape-mismatched keys (target-init): {mismatched}")
    return out
