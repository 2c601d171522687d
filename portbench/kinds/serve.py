"""A serving cell: an open loop of caption requests into ``InferenceEngine.submit``.

Set-up builds the program's eval-mode ``VALORModel`` holding the benchmark's
weights and one ``InferenceEngine`` (the mix's buckets and ``max_wait_ms``,
greedy ``tva`` captions of ``max_len`` tokens), draws the mix's pool of
requests and the arrival times from the seed, and warms every bucket twice
with a full batch.  The window is the arrivals' ``seconds``: this thread
submits each request when it is due; a collector thread stamps each caption
when it reaches it.  A request's latency runs from when it was due; one that
failed, was shed or is not done ``drain_s`` after the window's close counts
at that deadline.  With ``trace`` the same load goes on for ``trace_tail_s`` seconds after the
window, whose requests count in nothing: at the window's close the
benchmark's spans go around the engine's launch and finish of each batch and
hooks onto the LayerNorm modules, and the traced stretches
(``tracing.Stretches``: one batch thrown away, then two of ``trace_s``
seconds each) start, switched by the engine's worker at a batch's launch.  Afterwards the program is
freed and the reference checks a sample of the finished requests drawn from
the seed, the longest among them: every served token's logit against the
reference's best at its step (``logit_gap``).
"""

from __future__ import annotations

import gc
import math
import queue
import threading
import time
from typing import Any, Dict, List

import numpy as np

from portbench import flops, generators, harness, tracing, weights
from portbench.kinds.pretrain import _ln_hooks

SPANS = ("engine.launch", "engine.finish")
EOS = 102


def _spans(engine, stretches, record: Dict[str, Any]) -> None:
    """Wrap the engine's launch and finish of a batch in ``record_function``
    spans; each launch is a boundary of the traced stretches, crossed in the
    engine's worker thread before the batch is launched."""
    from torch.profiler import record_function

    launch, finish = engine._launch, engine._finish

    def traced_launch(reqs):
        stretches.advance()
        record["on"] = stretches.active and stretches.current[0] == "device"
        with record_function(SPANS[0]):
            return launch(reqs)

    def traced_finish(inflight):
        with record_function(SPANS[1]):
            return finish(inflight)

    engine._launch, engine._finish = traced_launch, traced_finish


def run(s: Dict[str, Any], seed: int, seconds: float, trace: bool, t_start: float) -> Dict[str, Any]:
    torch = harness.require_cuda(s["cell"]["chips"])
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import load_model
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig

    traffic, cfg = s["traffic"], s["config"]
    prog = harness.program_config(cfg)
    device = harness.device(torch)
    full = load_config(None, prog)
    w = weights.make(prog, seed, device)
    model = load_model(full.model, w, device)
    del w
    pool = generators.serve_pool(traffic, prog, seed)
    due = generators.arrivals(traffic["rate"], seconds, seed)
    n = len(due)
    if trace:  # the traced stretches follow the window, under the same load
        due = np.concatenate([due, seconds + generators.arrivals(traffic["rate"], traffic["trace_tail_s"], seed + 1)])
    which = generators.request_items(len(due), len(pool), seed)
    engine = InferenceEngine(model, ServeConfig(
        buckets=tuple(traffic["buckets"]), max_wait_ms=traffic["max_wait_ms"], group=traffic["group"],
        max_len=traffic["max_len"], max_pending=traffic["max_pending"]))
    ln = {"on": False, "calls": []}
    hooks: list = []
    stretches = tracing.Stretches(torch, length_s=traffic["trace_s"]) if trace else None
    for b in traffic["buckets"]:
        for _ in range(2):
            for f in [engine.submit(pool[i % len(pool)]) for i in range(b)]:
                f.result(timeout=600)
    harness.sync(torch, device)
    engine.reset_stats()

    t0 = time.monotonic()
    setup_s = t0 - t_start
    stats = {}

    def close():  # the engine's counters at the window's close, then the trace's spans, hooks and stretches
        stats.update(engine.stats())
        if trace:
            hooks.extend(_ln_hooks(torch, model, ln))
            _spans(engine, stretches, ln)
            stretches.armed = True

    loop = open_loop(engine, pool, due, which, t0, traffic["drain_s"], seconds, [(t0 + seconds, close)], counted=n)
    engine.shutdown(drain=False)
    if trace:
        stretches.finish()
        ln["on"] = False
    for h in hooks:
        h.remove()
    harness.sync(torch, device)
    peak = harness.peak_bytes(torch, device)

    latency, served, failed, completed = loop["latency_s"], loop["served"], loop["failed"], loop["completed"]
    ctx: Dict[str, Any] = {
        "kind": "serve", "latency_s": latency, "setup_s": setup_s, "window_s": seconds, "completed": completed,
        "chips": s["cell"]["chips"], "engine": stats,
        "request_flops": flops.caption_request(prog, traffic["frames"], traffic["clips"], traffic["max_len"]),
    }
    trace_summary = None
    if trace:
        ctx["trace"] = tracing.reduce_stretches(stretches, SPANS, ln["calls"])
        trace_summary = {k: ctx["trace"]["device"][k] for k in ("busy_s", "window_s")}
        harness.note(f"p95 {1e3 * harness.percentile(latency, 0.95):.3f} ms with tracing; "
                     f"trace {ctx['trace']['diagnostics']}")
    del engine, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sample = check_sample(served, traffic["check_requests"], seed)
    checks = {"logit_gap": reference_gap(torch, prog, seed, [pool[which[i]] for i in sample],
                                         [served[i] for i in sample], device)}
    checks["failed_share"] = failed / n
    judged = harness.judge(checks, s["limits"]["limits"])
    out = {
        "correct": harness.passed(judged),
        "attempted": n,
        "failed": failed,
        "metrics": harness.read_metrics(s["per_layer"] if trace else s["end_to_end"], ctx),
        "device": harness.device_info(torch, s["cell"]["chips"], peak, trace_summary),
        "checks": judged,
    }
    if trace:
        out["breakdown"] = ctx["trace"]["breakdown"]
    return out


def open_loop(engine, pool, due, which, t0: float, drain_s: float, seconds: float, ticks=(),
              counted: int = 0) -> Dict[str, Any]:
    """Submit request i at ``t0 + due[i]`` from this thread (``ticks``: (time,
    callback) pairs run when their time comes) and stamp each caption when a
    collector thread receives it.  The first ``counted`` requests (all when
    0) are the window's: for them it returns each latency from when it was due
    (a failed, shed or unfinished one at the deadline ``drain_s`` after the
    window's close), the served sequences, the failures, the captions done
    within the window and the requests due but not done at its middle and at
    its close (the backlog).  Later requests are sent and waited for alone."""
    from valor_tpu_torch.serve import EngineOverloaded

    n = len(due)
    done = [math.nan] * n
    results: List[Any] = [None] * n
    inbox: "queue.SimpleQueue" = queue.SimpleQueue()

    def collect():
        for _ in range(n):
            item = inbox.get()
            if item is None:
                return
            i, fut = item
            done[i] = time.monotonic()
            results[i] = fut

    collector = threading.Thread(target=collect, name="portbench-collector", daemon=True)
    collector.start()
    ticks = sorted(ticks, key=lambda t: t[0])

    def wait_until(at: float) -> None:
        """Sleep until ``at``, running each tick that falls due on the way: one
        wake a request or tick, so this thread takes the interpreter lock from
        the engine's worker as seldom as it can."""
        while True:
            now = time.monotonic()
            while ticks and now >= ticks[0][0]:
                ticks.pop(0)[1]()
            if now >= at:
                return
            time.sleep(min(at, ticks[0][0]) - now if ticks else at - now)

    for i in range(n):
        wait_until(t0 + float(due[i]))
        try:
            fut = engine.submit(pool[which[i]])
        except EngineOverloaded:
            inbox.put((i, None))
            continue
        fut.add_done_callback(lambda f, i=i: inbox.put((i, f)))
    window_end = t0 + seconds
    counted = counted or n
    wait_until(max([window_end] + [t for t, _ in ticks]))
    deadline = window_end + drain_s
    collector.join(timeout=max(max(deadline, t0 + float(due[-1]) + drain_s) - time.monotonic(), 0.0))
    if collector.is_alive():
        inbox.put(None)
        collector.join()
    latency, served, failed = [], {}, 0
    for i in range(counted):
        fut, t = results[i], done[i]
        if fut is not None and not fut.cancelled() and fut.exception() is None and t <= deadline:
            latency.append(t - (t0 + float(due[i])))
            served[i] = fut.result()["sequences"]
        else:
            failed += 1
            latency.append(deadline - (t0 + float(due[i])))
    completed = sum(1 for i in served if done[i] <= window_end)

    def outstanding(t: float) -> int:
        return sum(1 for i in range(counted) if t0 + float(due[i]) <= t and not done[i] <= t)

    return {"latency_s": latency, "served": served, "failed": failed, "completed": completed,
            "outstanding_mid": outstanding(t0 + seconds / 2), "outstanding_end": outstanding(window_end)}


def length(seq) -> int:
    """Tokens served up to and with the first EOS."""
    hits = np.flatnonzero(np.asarray(seq) == EOS)
    return int(hits[0]) + 1 if hits.size else len(seq)


def check_sample(served: Dict[int, Any], k: int, seed: int) -> List[int]:
    """``k`` finished requests drawn from the seed, the longest among them."""
    ids = sorted(served)
    if not ids:
        return []
    longest = max(ids, key=lambda i: (length(served[i]), -i))
    rest = [i for i in ids if i != longest]
    rng = np.random.Generator(np.random.PCG64([int(seed) & (2**64 - 1), 6]))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[j] for j in sorted(pick)]


def reference_logits(ref, torch, item: Dict[str, np.ndarray], seq, device):
    """The reference's logits at every served step of one request: [steps, V]."""
    from portbench.reference.fbank import log_mel_clips

    with torch.no_grad():
        pixels = torch.from_numpy(item["video_pixels"][None]).to(device)
        spec = log_mel_clips(torch.from_numpy(item["audio_waveforms"][None]).to(device),
                             torch.from_numpy(item["audio_valid_frames"][None]).to(device),
                             ref.shape.melbins, ref.shape.target_length)
        mem = torch.cat([ref.video_input(ref.encode_video(pixels)), ref.audio_input(ref.encode_audio(spec))], 1)
        served = torch.as_tensor(np.asarray(seq, np.int64), device=device)
        return ref.step_logits(served, ref.cross_kv(mem))[: length(seq)]


def build_reference(torch, prog: dict, seed: int, device, numerics: str = "fp32"):
    from portbench.reference.model import Numerics, ReferenceVALOR

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        ref = ReferenceVALOR(prog, Numerics(numerics))
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights.make(prog, seed, device), strict=True)
    return ref.eval()


def reference_gap(torch, prog: dict, seed: int, items, seqs, device) -> float:
    """The widest gap by which a served token's logit lies below the reference's best at its step."""
    if not seqs:
        return math.inf
    ref = build_reference(torch, prog, seed, device)
    gap = 0.0
    for item, seq in zip(items, seqs):
        logits = reference_logits(ref, torch, item, seq, device)
        tok = torch.as_tensor(np.asarray(seq[: logits.shape[0]], np.int64), device=device)
        picked = logits.gather(1, tok[:, None])[:, 0]
        gap = max(gap, float((logits.max(1).values - picked).max()))
    del ref
    gc.collect()
    return gap
