"""Dynamic-batching inference engine (counterpart of ``valor_tpu/serve/engine.py``).

Callers ``submit()`` single items from any thread; one background worker
coalesces compatible requests into the largest batch available within a
latency budget, pads it to a fixed *bucket* size, runs the decode, and
resolves per-request futures.

  * Buckets.  Batches are padded up to the smallest configured bucket by
    repeating the first row.  Rows are independent in every decode path, so
    padding cannot change the real rows, and the pad rows' outputs are
    dropped.  A few fixed batch shapes also keep the card's kernels on a few
    fixed configurations.
  * Compatibility keys.  Requests coalesce only when they share the per-item
    tensor signature (shape and dtype of each field) and the decode
    parameters (modality group, caption_type, max_len, beam, mode).  Each key
    has its own FIFO lane; lanes are served oldest-request-first.
  * One worker thread owns the device.  It enters ``torch.inference_mode()``
    itself (the mode is thread-local).
  * Latency budget.  A batch launches as soon as it is full, or when its
    oldest request has waited ``max_wait_ms``; while another batch is on the
    device, at the latest once it has waited ``max_wait_ms`` plus one batch
    cycle (``_pick``).
  * Double buffering.  Kernel launches are asynchronous, so the worker
    launches batch N+1 (host assembly, host-to-device copy, the decode's
    kernel launches) before it waits for batch N's results.  Rows are
    assembled in pinned host buffers, one per (key, bucket), and copied with
    ``non_blocking`` on a side stream that is synchronised before the buffer
    can be reused.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from valor_tpu_torch.eval.generate import Generator

__all__ = ["ServeConfig", "InferenceEngine", "EngineOverloaded"]


class EngineOverloaded(RuntimeError):
    """Raised by :meth:`InferenceEngine.submit` when the pending-request queue
    is at ``ServeConfig.max_pending``: a burst past the engine's throughput
    sheds load (HTTP 503 upstream) instead of growing the queue."""


# batch fields the engine understands -> per-ITEM rank (batched rank is +1):
# video [F,H,W,3], spectrograms [n_clips,mel,T], waveforms [n_clips,L],
# valid_frames [n_clips], prompts [L].  Anything else is rejected.
_ITEM_RANKS = {
    "video_pixels": 4,
    "audio_spectrograms": 3,
    "audio_waveforms": 2,
    "audio_valid_frames": 1,
    "question_prompt": 1,
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.

    buckets: allowed batch sizes, ascending; every launched batch is padded
      up to one of these.
    max_wait_ms: launch a partial batch once its oldest request has waited
      this long.  0 launches immediately; a negative value launches only
      full batches (and everything at shutdown).
    group: default modality group ("tva", "tv", "ta").
    max_pending: admission bound on queued (not yet launched) requests
      across all lanes; 0 disables it.
    """

    buckets: Tuple[int, ...] = (1, 4, 16, 64)
    max_wait_ms: float = 10.0
    group: str = "tva"
    caption_type: str = "unimlm"
    max_len: int = 30
    beam_size: int = 1
    mode: str = "greedy"
    prompt_key: str = "prompt_tokens_caption"
    max_pending: int = 1024

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be ascending and non-empty: {self.buckets}")


class _Request:
    __slots__ = ("item", "key", "future", "t_submit")

    def __init__(self, item, key):
        self.item = item
        self.key = key
        self.future: Future = Future()
        self.t_submit = time.monotonic()


def _signature(item: Dict[str, np.ndarray]) -> Tuple:
    return tuple((k, v.shape, str(v.dtype)) for k, v in sorted(item.items()))


class InferenceEngine:
    """Dynamic-batching server around :class:`~valor_tpu_torch.eval.generate.Generator`.

    Construct with a loaded model (``models.bridge.load_model``), then
    ``submit()`` per-item dicts (numpy media WITHOUT the batch dim, or with a
    leading 1) from any number of threads.  Each call returns a Future
    resolving to ``{"sequences": [max_len] int32, "logprobs": ...,
    "latency_s": float, "batch_size": int, "bucket": int}``.

    Use as a context manager or call ``shutdown()``: pending requests are
    drained before the worker exits.
    """

    def __init__(self, model, config: Optional[ServeConfig] = None,
                 prompts: Optional[Dict[str, np.ndarray]] = None):
        self.model = model
        self.cfg = config or ServeConfig()
        # task prompts keyed by group, each [1, L]; the decode broadcasts a
        # leading-1 prompt over the batch
        self.prompts = prompts or {}
        self._gen = Generator(model)
        self._device = model.device
        self._cuda = self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._lock = threading.Condition()
        self._lanes: "collections.OrderedDict[Tuple, collections.deque]" = (
            collections.OrderedDict()
        )
        self._pending = 0  # queued, not yet launched (admission bound)
        # per-(key, bucket) host assembly buffers: torch tensors (pinned on a
        # CUDA engine) and numpy views of them for the row copies
        self._buffers: "collections.OrderedDict[Tuple, Dict[str, Tuple[torch.Tensor, np.ndarray]]]" = (
            collections.OrderedDict()
        )
        self._stopping = False
        self._cycle_s = 0.0  # the last batch's device cycle (the age backstop's margin)
        self._last_launch = 0.0
        self._stats = self._fresh_stats()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="valor-serve-worker")
        self._worker.start()

    # -- public --------------------------------------------------------------
    def submit(self, item: Dict[str, Any], *, group: Optional[str] = None,
               max_len: Optional[int] = None, beam_size: Optional[int] = None,
               mode: Optional[str] = None) -> Future:
        c = self.cfg
        group = group or c.group
        norm: Dict[str, np.ndarray] = {}
        for k, v in item.items():
            rank = _ITEM_RANKS.get(k)
            if rank is None:
                raise KeyError(f"unknown item field {k!r}; expected {tuple(_ITEM_RANKS)}")
            a = np.asarray(v)
            if a.ndim == rank + 1 and a.shape[0] == 1:
                a = a[0]  # batched-with-leading-1 form
            if a.ndim != rank:
                raise ValueError(
                    f"{k}: expected rank {rank} per-item tensor "
                    f"(or leading-1 batch), got shape {a.shape}"
                )
            norm[k] = a
        if not norm:
            raise ValueError("empty item: provide at least one media field")
        key = (
            _signature(norm), group, c.caption_type,
            max_len or c.max_len, beam_size or c.beam_size, mode or c.mode,
        )
        req = _Request(norm, key)
        with self._lock:
            if self._stopping:
                raise RuntimeError("engine is shut down")
            if c.max_pending and self._pending >= c.max_pending:
                self._stats["shed"] += 1
                raise EngineOverloaded(
                    f"{self._pending} requests pending (max_pending={c.max_pending}); retry later"
                )
            self._lanes.setdefault(key, collections.deque()).append(req)
            self._pending += 1
            self._stats["requests"] += 1
            self._lock.notify()
        return req.future

    def generate(self, item: Dict[str, Any], **kw) -> Dict[str, Any]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(item, **kw).result()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s = self._stats
            lat = sorted(s["latency_s"])
            q = sorted(s["queue_s"])
            occ = s["occupancy"]

            def pct(xs, p):
                return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else 0.0

            # per-batch phase breakdown: host assembly (row copies into the
            # pinned buffer), h2d (the copy to the card, waited for), device
            # (decode launch -> results on the host; under double buffering
            # this interval also spans the NEXT batch's launch), fan-out
            # (future delivery).  Request-side queueing is queue_* below.
            phases = {
                p: float(np.mean(s[f"phase_{p}_s"])) if s[f"phase_{p}_s"] else 0.0
                for p in ("assemble", "h2d", "device", "fanout")
            }
            total = sum(phases.values()) or 1.0
            return {
                "requests": s["requests"],
                "batches": s["batches"],
                "shed": s["shed"],
                "queue_depth": self._pending,
                "rows_real": s["rows_real"],
                "rows_run": s["rows_run"],
                "pad_fraction": 1.0 - s["rows_real"] / max(1, s["rows_run"]),
                "mean_occupancy": float(np.mean(occ)) if occ else 0.0,
                "latency_p50_s": pct(lat, 0.50),
                "latency_p95_s": pct(lat, 0.95),
                "latency_p99_s": pct(lat, 0.99),
                "queue_p50_s": pct(q, 0.50),
                "queue_p95_s": pct(q, 0.95),
                "batch_phase_mean_s": {k: round(v, 4) for k, v in phases.items()},
                "batch_phase_fraction": {k: round(v / total, 4) for k, v in phases.items()},
                "decoders": {str(k): v for k, v in self._gen.stats().items()},
            }

    @staticmethod
    def _fresh_stats() -> Dict[str, Any]:
        # bounded histories: a resident server must not grow one float per
        # request forever
        return {
            "requests": 0, "batches": 0, "shed": 0, "rows_run": 0, "rows_real": 0,
            "queue_s": collections.deque(maxlen=10000),
            "latency_s": collections.deque(maxlen=10000),
            "occupancy": collections.deque(maxlen=10000),
            "phase_assemble_s": collections.deque(maxlen=10000),
            "phase_h2d_s": collections.deque(maxlen=10000),
            "phase_device_s": collections.deque(maxlen=10000),
            "phase_fanout_s": collections.deque(maxlen=10000),
        }

    def reset_stats(self):
        """Zero the counters (benchmarks call this after warmup)."""
        with self._lock:
            self._stats = self._fresh_stats()

    def shutdown(self, drain: bool = True):
        with self._lock:
            self._stopping = True
            if not drain:
                for lane in self._lanes.values():
                    while lane:
                        lane.popleft().future.cancel()
                self._lanes.clear()
                self._pending = 0
            self._lock.notify_all()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- worker --------------------------------------------------------------
    def _pick(self, inflight_since: Optional[float] = None) -> Optional[List[_Request]]:
        """Under the lock: pop the next launchable batch, or None.

        inflight_since: launch time of the batch currently on the device, or
        None if the device is idle.  While a batch is in flight, the overlap
        slot takes (a) any FULL top-bucket lane, (b) an aged partial lane
        whose NEWEST request predates the in-flight launch (the lane stopped
        growing a whole device cycle ago), or (c) a partial lane whose oldest
        request has waited ``max_wait_ms`` plus one batch cycle (from the last
        finished batch's launch to the next launch, or to its result if
        nothing launched after it): a lane that receives a request every
        cycle would otherwise wait until it fills.  Other partial lanes still
        receiving traffic are skipped; they launch the moment the device would
        otherwise go idle.  Lanes whose requests were all cancelled are
        dropped in a loop, however many there are."""
        c = self.cfg
        while True:
            now = time.monotonic()
            best_key, best_age = None, -1.0
            for key, lane in self._lanes.items():
                if not lane:
                    continue
                age = now - lane[0].t_submit
                full = len(lane) >= c.buckets[-1]
                aged = c.max_wait_ms >= 0 and age * 1e3 >= c.max_wait_ms
                overdue = aged and age >= c.max_wait_ms / 1e3 + self._cycle_s
                if (inflight_since is not None and not full and not self._stopping
                        and lane[-1].t_submit >= inflight_since and not overdue):
                    continue
                if full or self._stopping or aged:
                    if age > best_age:
                        best_key, best_age = key, age
            if best_key is None:
                return None
            lane = self._lanes[best_key]
            n = min(len(lane), c.buckets[-1])
            self._pending -= n
            out = [lane.popleft() for _ in range(n)]
            if not lane:
                del self._lanes[best_key]
            # requests cancelled while queued never occupy batch rows
            live = [r for r in out if not r.future.cancelled()]
            if live:
                return live

    def _deadline(self) -> Optional[float]:
        """Under the lock: seconds until the oldest pending request matures."""
        c = self.cfg
        if c.max_wait_ms < 0:  # age trigger disabled: launch only when full
            return None
        oldest = None
        for lane in self._lanes.values():
            if lane:
                t = lane[0].t_submit
                oldest = t if oldest is None else min(oldest, t)
        if oldest is None:
            return None
        return max(0.0, oldest + c.max_wait_ms / 1e3 - time.monotonic())

    def _loop(self):
        with torch.inference_mode():
            self._serve()

    def _serve(self):
        """Double-buffered worker: launch batch N+1 while batch N's kernels
        run, then wait for N and deliver it.  With nothing new to launch the
        in-flight batch is finished at once."""
        inflight = None
        inflight_since = None
        while True:
            with self._lock:
                batch = self._pick(inflight_since=inflight_since)
                while batch is None and inflight is None:
                    if self._stopping and not any(self._lanes.values()):
                        return
                    self._lock.wait(timeout=self._deadline())
                    batch = self._pick()
            nxt = nxt_since = None
            if batch is not None:
                try:
                    nxt = self._launch(batch)
                    nxt_since = time.monotonic()
                except Exception as e:  # surface to callers, keep serving
                    for r in batch:
                        self._deliver(r, e, error=True)
            if inflight is not None:
                try:
                    self._finish(inflight)
                except Exception as e:
                    for r in inflight[0]:
                        self._deliver(r, e, error=True)
            inflight, inflight_since = nxt, nxt_since

    def _assemble(self, reqs: List[_Request], bucket: int) -> Dict[str, torch.Tensor]:
        """Copy request rows into the (key, bucket) host buffer; rows beyond
        ``len(reqs)`` repeat row 0."""
        bkey = (reqs[0].key, bucket)
        buf = self._buffers.get(bkey)
        if buf is None:
            buf = {}
            for k, v in reqs[0].item.items():
                t = torch.from_numpy(np.empty((bucket,) + v.shape, v.dtype))
                if self._cuda:
                    t = t.pin_memory()
                buf[k] = (t, t.numpy())
            self._buffers[bkey] = buf
            while len(self._buffers) > 8:  # bound resident buffer memory
                self._buffers.popitem(last=False)
        self._buffers.move_to_end(bkey)
        n = len(reqs)
        for k, (_, arr) in buf.items():
            for i in range(n):
                arr[i] = reqs[i].item[k]
            if n < bucket:
                arr[n:] = arr[0]
        return {k: t for k, (t, _) in buf.items()}

    def _to_device(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The batch on the model's device.  On the card: non_blocking copies
        from the pinned buffers on the side stream, which is synchronised
        before returning, so the buffers are free for the next batch.  On the
        CPU the decode reads the host buffers in place and ends inside
        _launch, before the buffers are reused."""
        if not self._cuda:
            return host
        with torch.cuda.stream(self._copy_stream):
            out = {k: t.to(self._device, non_blocking=True) for k, t in host.items()}
        self._copy_stream.synchronize()
        main = torch.cuda.current_stream(self._device)
        for t in out.values():
            t.record_stream(main)  # freed memory is reused only after main's work
        return out

    @staticmethod
    def _deliver(r: _Request, payload, *, error: bool = False):
        """Resolve a future, skipping ones the caller already cancelled and
        ones already resolved."""
        if r.future.done():
            return
        if r.future.set_running_or_notify_cancel():
            if error:
                r.future.set_exception(payload)
            else:
                r.future.set_result(payload)

    def _launch(self, reqs: List[_Request]):
        """Assemble, copy and launch one batch (no wait for its results)."""
        c = self.cfg
        _, group, caption_type, max_len, beam_size, mode = reqs[0].key
        n = len(reqs)
        bucket = next((b for b in c.buckets if b >= n), c.buckets[-1])
        t_q = self._last_launch = time.monotonic()
        host = self._assemble(reqs, bucket)
        if "question_prompt" not in host:
            p = self.prompts.get(group)
            if p is not None:
                host[c.prompt_key] = torch.as_tensor(np.asarray(p))
        t0 = time.monotonic()
        batch = self._to_device(host)
        t_h2d = time.monotonic()
        out = self._gen.generate(
            batch, (group,), caption_type=caption_type, max_len=max_len,
            beam_size=beam_size, mode=mode, prompt_key=c.prompt_key,
        )
        return (reqs, n, bucket, group, out, t_q, t0, t_h2d)

    def _finish(self, inflight):
        """Wait for the launched batch's results and deliver the futures.
        Stats are recorded BEFORE the futures resolve, so a caller that reads
        ``stats()`` right after ``result()`` sees its batch counted."""
        reqs, n, bucket, group, out, t_q, t0, t_h2d = inflight
        seqs = out[f"generated_sequences_{group}"].cpu().numpy()
        logps = out[f"logprobs_{group}"].cpu().numpy()
        t1 = time.monotonic()
        self._cycle_s = (self._last_launch if self._last_launch > t_q else t1) - t_q
        with self._lock:
            s = self._stats
            s["batches"] += 1
            s["rows_run"] += bucket
            s["rows_real"] += n
            s["occupancy"].append(n / bucket)
            s["phase_assemble_s"].append(t0 - t_q)
            s["phase_h2d_s"].append(t_h2d - t0)
            # launch to result on the host's clock: under double buffering it
            # also holds the host's launch of the next batch, so it is not
            # the device's busy time
            s["phase_device_s"].append(t1 - t_h2d)
            for r in reqs:
                s["latency_s"].append(t1 - r.t_submit)
                s["queue_s"].append(t_q - r.t_submit)
        for i, r in enumerate(reqs):
            self._deliver(r, {
                "sequences": seqs[i],
                "logprobs": logps[i],
                "latency_s": t1 - r.t_submit,
                "batch_size": n,
                "bucket": bucket,
            })
        t2 = time.monotonic()
        with self._lock:
            self._stats["phase_fanout_s"].append(t2 - t1)
