#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``valor_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a non-zero
exit code, and no result line:

  1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
     and the build of every kernel from ``valor_tpu_torch/csrc`` with nvcc;
  2. the LayerNorm kernel against its plain version at the shapes the serving
     and pretraining paths give it, bf16 -> bf16 and f32 -> f32 (and the mixed
     pairs at the fusion shape), with its device time (from CUDA graph
     replays) beside the plain version's, ``F.layer_norm``'s and the bytes
     bound, and the wrapper's host cost a call;
  3. the whole port on the card against the whole port on the CPU: the tiny
     config in fp32 (TF32 off), greedy and beam-3 ``cap%tva`` sequences equal
     token for token, decoder logits within 1e-4;
  4. full-width VALOR-base caption serving (``configs/caption-valor32k.json``,
     bf16, seeded random weights) through ``InferenceEngine``: 48 greedy
     requests from 8 threads, then one beam-3 batch of 4; every row equal to a
     direct ``Generator.generate`` at its bucket size, and the kernel launch
     count equal to the number of LayerNorms the served batches run;
  5. the HTTP frontend with the image featurizer: /healthz, four POST
     /generate with JPEG paths, /stats and a 400 case;
  6. the LayerNorm backward kernel against its plain version at the shapes
     the pretraining step gives it at batch 32 (and a ragged and a 4096-wide
     one), bf16 and f32 (and x and dy in different types at the fusion
     shape), with its device time beside the plain version's,
     the ATen backward of ``F.layer_norm`` (``library_ms``) and the bytes
     bound, and the wrapper's host cost a call;
  7. one training step of the tiny config on the card against the same step
     on the CPU, fp32 with TF32 off: losses within 1e-4, every parameter
     gradient and every updated parameter within the stated tolerances;
  8. full-width VALOR-base pretraining (``configs/pretrain-valor-base.json``,
     ``pt_contra%tva%tv%ta_caption%tva%tv%ta``, bf16, seeded random weights)
     through ``Trainer.run`` at batch 32: one warm-up step and ten timed
     steps on one repeated synthetic batch; every loss finite, the last
     step's total loss below the first's, and the forward and backward kernel
     launches equal to the LayerNorms each step runs;
  9. every (rows, cols, eps, dtypes) that the main paths of phases 4 and 8
     handed each kernel is held against the plain version: listed where
     phase 2 or 6 compared it, compared here where they did not.

It prints a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero without printing them where CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
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
]
LN_BWD_SHAPES = [  # name, rows, cols, eps: what the pretraining step at batch 32 hands the backward
    ("vit_b16_32x4frames", 32 * 4 * 197, 768, 1e-5),
    ("clip_text_32x40", 32 * 40, 512, 1e-5),
    ("ast_32x1clip", 32 * 129, 768, 1e-12),
    ("fusion_32x40", 32 * 40, 768, 1e-12),
    ("ragged", 1000, 500, 1e-5),
    ("wide", 2048, 4096, 1e-5),
]
# (x dtype, out dtype for the forward or dy dtype for the backward): both kernels
# take each type on either side; the matched pairs at every shape, the mixed
# ones at the fusion shape
MATCHED = [("bfloat16", "bfloat16"), ("float32", "float32")]
MIXED = [("float32", "bfloat16"), ("bfloat16", "float32")]
PT_TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"


def log(msg: str) -> None:
    print(msg, flush=True)


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


# -- phase 1 ------------------------------------------------------------------
def phase_card_and_build():
    import torch

    from valor_tpu_torch.ops.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    for name in names:
        _build.load_library(name)
    log(f"build: {names} in {time.monotonic() - t0:.1f} s")
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
                "bound_ms": (n * c * (x.element_size() + dtype.itemsize) + 2 * c * 4)
                / HBM_BYTES_PER_S * 1e3,
            }
            rows.append(row)
            log("layernorm " + json.dumps(row))
    return rows


# -- phase 3 ------------------------------------------------------------------
def phase_card_vs_cpu():
    import torch

    from valor_tpu_torch.eval.generate import Generator, make_fusion_decoder
    from valor_tpu_torch.models.bridge import init_params, load_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_config()
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


def expected_ln_launches(model) -> int:
    """LayerNorm launches of one served cap%tva batch: every LayerNorm of the
    two encoders and the adapters once, and every LayerNorm of the fusion
    encoder (embedding LN, self, cross and output LN of each layer) and of
    the head once per decode step.  26 + 25 + 38 * 30 = 1191 for VALOR-base."""
    from valor_tpu_torch.ops.layers import LayerNorm

    def count(*mods):
        return sum(isinstance(x, LayerNorm) for m in mods if m is not None for x in m.modules())

    encode = count(model.clip_vision, model.audio_encoder,
                   getattr(model, "video_adapter_ln", None), getattr(model, "audio_adapter_ln", None))
    step = count(model.multimodal_encoder, model.cls_head)
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

    from valor_tpu_torch.cli.serve import image_featurizer, start_server
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
            server = start_server(eng, image_featurizer(cfg),
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
            finally:
                server.shutdown()
                server.server_close()
    log("http " + json.dumps({
        "generate": [{"bucket": o["bucket"], "batch_size": o["batch_size"],
                      "latency_s": o["latency_s"], "text": o["text"][:40]} for _, o in outs],
        "stats_batches": stats["batches"], "bad_request": code,
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
            wl, bl = w.to(x.dtype), torch.zeros(c, device="cuda", dtype=x.dtype)
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [c], wl, bl, eps)
            dyl = dy.to(x.dtype)
            row = {
                "shape": f"{name} [{n}, {c}] {xd}" + (f" dy {gd}" if gd != xd else ""),
                "sig": [n, c, eps, xd, gd], "max_abs_err": max(ex, ew, eb),
                "dx_err": ex, "dw_err": ew, "db_err": eb,
                "tol": "dx 1 ulp + 1e-5 max|dx|; dw, db 1e-5 sum|terms|",
                "kernel_ms": graph_ms(lambda: K.layernorm_bwd(x, w, eps, dy)),
                "plain_ms": graph_ms(lambda: K.layernorm_bwd_plain(x, w, eps, dy)),
                "library_ms": graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                    dyl, x, [c], mean, rstd, wl, bl, [True, True, True])),
                "kernel_host_us": host_us(lambda: K.layernorm_bwd(x, w, eps, dy)),
                "bound_ms": (n * c * (2 * x.element_size() + dy.element_size()) + 3 * c * 4)
                / HBM_BYTES_PER_S * 1e3,
            }
            rows.append(row)
            log("layernorm_bwd " + json.dumps(row))
            del x, dy, dyl, mean, rstd
    return rows


# -- phase 7 ------------------------------------------------------------------
def phase_train_card_vs_cpu(device: str = "cuda"):
    """One pretraining step of the tiny config (fp32, caption_type lm, dropout
    0: no random draws) on the card and on the CPU from the same weights.
    Losses within 1e-4; gradients within 1e-4 absolute and relative (fp32
    sums in another order); updated parameters: every element within one
    learning-rate step and 99.9 % within 2 % of one (Adam turns a relative
    difference of a near-zero gradient into one of its step)."""
    import torch

    from valor_tpu_torch.core.config import TrainConfig
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import pretrain_batch
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.ops.layers import RNGStreams, rng_scope
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import param_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(tiny_config(), caption_type="lm", dropout=0.0)
    lr = 1e-3
    tcfg = TrainConfig(learning_rate=lr, clip_lr=lr, clip_lr_text=lr, num_train_steps=10, grad_norm=0.5)
    sd = init_params(cfg, seed=0, device="cpu")
    data = pretrain_batch(cfg, 4, frames=2, clips=1, n_txt=8, seed=1)
    task = parse_task(PT_TASK)
    res = {}
    for dev in ("cpu", device):
        model = train_model(cfg, {k: v.to(dev) for k, v in sd.items()}, dev)
        opt = build_optimizer(model, tcfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        fwd, bwd = K.LAUNCHES, K.LAUNCHES_BWD
        with rng_scope(RNGStreams(0)):
            losses = model(batch, task)
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
    out = {"losses_cuda": l_gpu, "losses_cpu": l_cpu, "max_loss_diff": loss_err,
           "max_grad_diff": grad_err, "max_param_diff": float(diff.max()),
           "params_within_2pct_step": within, "layernorm_launches_fwd_bwd": launches}
    log("card vs cpu training step " + json.dumps(out))
    return out


# -- phase 8 ------------------------------------------------------------------
def expected_train_ln_launches(model, spec) -> int:
    """LayerNorms one pretraining step runs (each once forward and once
    backward): the towers the task's groups use, the adapters, and the fusion
    encoder with its head once per caption and MLM group.  26 ViT + 25 CLIP
    text + 25 AST + 3 x 38 fusion = 190 for VALOR-base on pt_contra%tva%tv%ta_caption%tva%tv%ta."""
    from valor_tpu_torch.ops.layers import LayerNorm

    def count(mod, skip_cross=False):
        if mod is None:
            return 0
        return sum(isinstance(x, LayerNorm) and not (skip_cross and "cross_attn" in name)
                   for name, x in mod.named_modules())

    n = 0
    if spec.uses_video:
        n += count(model.clip_vision) + count(getattr(model, "video_adapter_ln", None))
    if spec.uses_audio:
        n += count(model.audio_encoder) + count(getattr(model, "audio_adapter_ln", None))
    if spec.contra_groups and any("t" in g for g in spec.contra_groups):
        n += count(model.text_encoder, skip_cross=True)
    fusion = count(model.multimodal_encoder) + count(model.cls_head)
    return n + fusion * (len(spec.caption_groups) + len(spec.mlm_groups))


def phase_pretrain(batch_size: int = 32, steps: int = 10, cfg=None, device: str = "cuda"):
    """``cfg`` None is VALOR-base; a CPU rehearsal passes a tiny config and device "cpu"."""
    import torch

    from valor_tpu_torch.core.config import Config, load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.synthetic import pretrain_batch
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.ops.kernels import layernorm as K
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState
    from valor_tpu_torch.train.trainer import Trainer

    full = load_config(str(ROOT / "configs" / "pretrain-valor-base.json"))
    cfg = cfg or full.model
    # the schedule spans this run: warm-up to the config's peak rate in the first step
    tcfg = dataclasses.replace(full.train, num_train_steps=steps + 1)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.monotonic()
    model = train_model(cfg, init_params(cfg, seed=0, device=device), device)
    state = TrainState(model, build_optimizer(model, tcfg, cfg.frozen_vision, cfg.frozen_multimodal))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"VALOR-base pretraining model ({cfg.dtype}, {n_params / 1e6:.1f} M params, "
        f"remat {cfg.checkpointing}) built in {time.monotonic() - t0:.1f} s")
    data = pretrain_batch(cfg, batch_size, frames=4, clips=1, n_txt=40, seed=0)
    per_step = expected_train_ln_launches(model, parse_task(PT_TASK))
    stamps = []

    def hook(micro, task_name, metrics):
        sync()
        stamps.append(time.perf_counter())

    trainer = Trainer(Config(model=cfg, train=tcfg), state, [(PT_TASK, data)] * (steps + 1),
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
        "batch": batch_size, "timed_steps": steps, "median_step_s": median,
        "samples_per_s": batch_size / median, "warmup_step_s": float(step_s[0]),
        "step_s": [float(v) for v in step_s],
        "max_memory_allocated_gib": peak / 2**30, "params_m": n_params / 1e6,
        "total_loss": totals, "contra_loss": [h[2]["contra_loss"] for h in trainer.history],
        "caption_loss": [h[2]["caption_loss"] for h in trainer.history],
        "grad_norm": [h[2]["grad_norm"] for h in trainer.history],
        "layernorm_launches_fwd_bwd": launches, "per_step": per_step,
        "layernorm_calls": sorted(sigs_fwd), "layernorm_bwd_calls": sorted(sigs_bwd),
    }
    log("pretrain " + json.dumps(summary))
    return summary


# -- phase 9 ------------------------------------------------------------------
def phase_path_shapes(serving, pretrain, ln_rows, bwd_rows):
    """Every (rows, cols, eps, dtypes) that the main paths of phases 4 and 8
    handed each kernel, held against its plain version: those that phases 2
    and 6 compared are listed as such, the others are compared here (on new
    seeded inputs, with the same tolerances, untimed)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for kind, sigs, rows in (
        ("fwd", serving["layernorm_calls"] + pretrain["layernorm_calls"], ln_rows),
        ("bwd", pretrain["layernorm_bwd_calls"], bwd_rows),
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
    log("path shapes " + json.dumps(out))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import init_params, load_model

    phase_card_and_build()
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
    shapes = phase_path_shapes(serving, pretrain, ln_rows, bwd_rows)

    fwd_row, bwd_row = ln_rows[0], bwd_rows[0]  # the ViT shape in bf16: the largest on both paths
    by_path = {"serving": serving["layernorm_launches"], "pretraining": pretrain["layernorm_launches_fwd_bwd"][0]}
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
        "launches": pretrain["layernorm_launches_fwd_bwd"][1],
        "launches_by_path": {"serving": 0, "pretraining": pretrain["layernorm_launches_fwd_bwd"][1]},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows + shapes["bwd"]["compared_here"]),
        "ms": bwd_row["kernel_ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": "bytes",
        "library_ms": bwd_row["library_ms"], "shape": bwd_row["shape"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
