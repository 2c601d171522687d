"""HTTP serving frontend of the port (counterpart of ``valor_tpu/cli/serve.py``).

    python -m valor_tpu_torch.cli.serve --config configs/caption-valor32k.json \
        --task cap%tva --port 8000 --bucket 16 --max_wait_ms 25 [--checkpoint <run dir>]

The model is resident on the CUDA card (``--device cpu`` runs it on the
CPU), and concurrent requests are coalesced into padded fixed-bucket batches
by ``valor_tpu_torch/serve/engine.py``; ``max_wait_ms`` bounds the batching
latency added to any request.  ``--checkpoint`` names one of the port's own run
directories, whose latest ``ckpt/step_N`` is served (``FileNotFoundError``
where there is none: the JAX package serves random weights there); without it
the weights are random from seed 0.  The WordPiece vocab is read from
``$VALOR_BERT_VOCAB`` (``pretrained_weights/bert-base-uncased-vocab.txt`` by
default).

Endpoints (JSON in/out):
  GET  /healthz    -> {"ok": true}
  GET  /stats      -> engine counters + latency percentiles + decoders
  POST /generate   -> {"image_path": ...} or {"video_path": ...} [+ "question",
                      "question_pad", "video_sample_num", "audio_sample_num",
                      "group", "max_len", "beam_size"]
                      -> {"text": ..., "latency_s": ..., "batch_size": ..., "bucket": ...}

Media arrive as server-local paths; featurization runs on the HTTP thread so
the device worker never blocks on IO.  An image is one raw uint8 frame with
silent audio; a video goes through ffmpeg (``cli/infer.py``'s
``extract_frames_and_wav``) into ``video_sample_num`` raw uint8 frames (8 by
default; the C++ decoder of ``data/native.py`` where it builds) and
``audio_sample_num`` host log-mel clips (2).  A missing or unreadable medium
is a 400.  A ``question`` becomes the QA prompt ``[CLS] question [SEP]``,
zero-padded to ``question_pad`` tokens (32 by default) so that requests batch
together; a longer question is never cut (the JAX package cuts it at
``question_pad``): its pad grows to its length, rounded up to a multiple of 8.
A config with ``use_task_prompt`` (a prompt-trained checkpoint) serves as
evaluation runs it: the caption prompt goes to every caption decode, and the
QA prompt's body follows the ``[CLS]`` of every question (``data/prompts.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict

import numpy as np

from valor_tpu_torch.core.logging import LOGGER

FeaturizeFn = Callable[[Dict[str, Any]], Dict[str, np.ndarray]]
DecodeFn = Callable[[np.ndarray], str]

DEFAULT_BERT_VOCAB = os.environ.get(
    "VALOR_BERT_VOCAB", "pretrained_weights/bert-base-uncased-vocab.txt"
)


def make_handler(engine, featurize: FeaturizeFn, decode: DecodeFn,
                 *, request_timeout_s: float = 300.0,
                 max_body_bytes: int = 1 << 20):
    """Build the request-handler class around an engine and its codecs.

    Error contract: client mistakes (bad JSON, unknown fields, wrong shapes)
    are 400; oversized bodies 413; engine admission shed 503; a request that
    exceeds ``request_timeout_s`` 504; anything else (an internal engine or
    device failure, or a feature not ported yet) 500.
    """
    from concurrent.futures import TimeoutError as FutureTimeout

    from valor_tpu_torch.serve.engine import EngineOverloaded

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # route through our logger, quietly
            LOGGER.debug("serve: " + fmt % a)

        def _json(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                self._json(200, engine.stats())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    self._json(413, {"error": f"body {n} bytes exceeds limit {max_body_bytes}"})
                    return
                payload = json.loads(self.rfile.read(n) or b"{}")
                item = featurize(payload)
                kw = {}
                if payload.get("group"):
                    kw["group"] = payload["group"]
                for k in ("max_len", "beam_size"):
                    if payload.get(k) is not None:
                        kw[k] = int(payload[k])
                fut = engine.submit(item, **kw)
                try:
                    result = fut.result(timeout=request_timeout_s)
                except FutureTimeout:
                    # a cancelled queued request is dropped at batch-pick time
                    fut.cancel()
                    raise
                self._json(200, {
                    "text": decode(result["sequences"]),
                    "latency_s": result["latency_s"],
                    "batch_size": result["batch_size"],
                    "bucket": result["bucket"],
                })
            except EngineOverloaded as e:
                self._json(503, {"error": str(e), "retry": True})
            except FutureTimeout:
                self._json(504, {"error": f"request exceeded {request_timeout_s}s"})
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError, FileNotFoundError) as e:
                # validation errors: the caller's payload is at fault
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - internal failure
                LOGGER.exception("serve: internal error")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def start_server(engine, featurize: FeaturizeFn, decode: DecodeFn,
                 host: str = "127.0.0.1", port: int = 8000,
                 **handler_kw) -> ThreadingHTTPServer:
    """Start serving on a daemon thread; returns the live server (its
    ``server_address`` carries the bound port when ``port=0``).  Stop it with
    ``shutdown()`` and ``server_close()``."""
    server = ThreadingHTTPServer((host, port), make_handler(engine, featurize, decode, **handler_kw))
    t = threading.Thread(target=server.serve_forever, daemon=True, name="valor-serve-http")
    t.start()
    return server


def question_prompt(bert_tok, question: str, pad: int = 32, body=()) -> np.ndarray:
    """``[CLS] body question [SEP]`` as int32 ids (``body``: the QA task
    prompt's ids, or none), zero-padded to ``pad`` or, for a longer one, to its
    length rounded up to a multiple of 8."""
    q = ([bert_tok.cls_token_id] + [int(t) for t in body] + bert_tok.encode(question)
         + [bert_tok.sep_token_id])
    width = max(pad, -(-len(q) // 8) * 8)
    return np.asarray(q + [0] * (width - len(q)), np.int32)


def production_featurizer(model_cfg, bert_tok=None, prompt_table=None) -> FeaturizeFn:
    """The request featurizer (the JAX package's ``_production_featurize``):
    ``image_path`` -> one raw uint8 frame plus silent spectrogram clips, as the
    eval image mapper gives them; ``video_path`` -> ffmpeg frames and wav in a
    temporary directory, then ``video_sample_num`` raw uint8 frames from
    ``VideoMapper`` and ``audio_sample_num`` log-mel clips from
    ``AudioMapper``; with a ``question`` its prompt (``question_prompt``,
    encoded by ``bert_tok``, with the QA prompt body of ``prompt_table`` when
    there is one)."""
    import subprocess
    import tempfile

    from valor_tpu_torch.cli.infer import extract_frames_and_wav
    from valor_tpu_torch.data.pipeline import AudioMapper, VideoMapper, load_image_uint8

    body = prompt_table.qa_body()[0].tolist() if prompt_table is not None else ()

    def video(payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
        path = payload["video_path"]
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no such video: {path}")
        with tempfile.TemporaryDirectory() as tmp:
            try:
                extract_frames_and_wav(path, tmp)
            except subprocess.CalledProcessError as e:  # ffmpeg cannot read it -> client 400
                raise FileNotFoundError(f"unreadable video: {path} ({e})") from None
            pixels = VideoMapper(
                tmp, resolution=model_cfg.video_resolution,
                sample_num=int(payload.get("video_sample_num", 8)), datatype="video",
                encoder_type=model_cfg.video_encoder_type, training=False, output_uint8=True,
            )["frames"]
            if pixels is None:
                raise FileNotFoundError(f"no readable frames in: {path}")
            audio = AudioMapper(
                tmp, sample_num=int(payload.get("audio_sample_num", 2)),
                melbins=model_cfg.audio_melbins, target_length=model_cfg.audio_target_length,
                training=False,
            )["audio"]
        return {"video_pixels": pixels, "audio_spectrograms": audio.astype(np.float32)}

    def featurize(payload: Dict[str, Any]) -> Dict[str, np.ndarray]:
        if payload.get("image_path"):
            path = payload["image_path"]
            try:
                pixels = load_image_uint8(path, model_cfg.video_resolution)
            except OSError as e:  # unreadable or missing image -> client 400
                raise FileNotFoundError(f"unreadable image: {path} ({e})") from None
            item = {
                "video_pixels": pixels,
                "audio_spectrograms": np.zeros(
                    (int(payload.get("audio_sample_num", 2)),
                     model_cfg.audio_melbins, model_cfg.audio_target_length), np.float32),
            }
        elif payload.get("video_path"):
            item = video(payload)
        else:
            raise ValueError("payload needs video_path or image_path")
        if payload.get("question"):
            if bert_tok is None:
                raise RuntimeError("this featurizer was built without a tokenizer for questions")
            item["question_prompt"] = question_prompt(
                bert_tok, payload["question"], int(payload.get("question_pad", 32)), body)
        return item

    return featurize


def buckets_up_to(bucket: int):
    """1, 4, 16, ... (powers of 4 below ``bucket``), then ``bucket``."""
    out, b = [], 1
    while b < bucket:
        out.append(b)
        b *= 4
    return tuple(out) + (bucket,)


def serve(argv=None):
    """Parse the CLI, build the model, the engine and the HTTP server, and
    start serving on a daemon thread; returns (server, engine)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--task", default="cap%tva")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--bucket", type=int, default=16,
                        help="max batch; buckets are 1..bucket powers of 4")
    parser.add_argument("--max_wait_ms", type=float, default=25.0)
    parser.add_argument("--beam_size", type=int, default=1)
    parser.add_argument("--max_pending", type=int, default=1024,
                        help="queued-request admission bound (503 past it)")
    parser.add_argument("--request_timeout_s", type=float, default=300.0)
    parser.add_argument("--max_body_bytes", type=int, default=1 << 20)
    parser.add_argument("--device", default=None, help="torch device; the CUDA card by default")
    args = parser.parse_args(argv)

    from valor_tpu_torch.cli.build import model_weights
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.prompts import maybe_prompt_table
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.validate import decode_sequence
    from valor_tpu_torch.models.bridge import load_model
    from valor_tpu_torch.serve import InferenceEngine, ServeConfig

    cfg = load_config(args.config)
    spec = parse_task(args.task)
    group = spec.caption_groups[0]
    bert_tok = BertTokenizer(DEFAULT_BERT_VOCAB)
    # the serving prompts follow the fusion encoder's tokenizer (BERT here)
    table = maybe_prompt_table(cfg.model, (bert_tok, None))
    model = load_model(cfg.model, model_weights(cfg.model, args.checkpoint, args.device), args.device)
    engine = InferenceEngine(
        model,
        ServeConfig(
            buckets=buckets_up_to(args.bucket), max_wait_ms=args.max_wait_ms,
            group=group, caption_type=cfg.model.caption_type,
            max_len=cfg.model.max_generation_len, beam_size=args.beam_size,
            max_pending=args.max_pending,
        ),
        prompts={group: table.caption()} if table is not None else None,
    )
    server = start_server(
        engine, production_featurizer(cfg.model, bert_tok, table),
        lambda seq: decode_sequence(bert_tok, seq),
        host=args.host, port=args.port,
        request_timeout_s=args.request_timeout_s,
        max_body_bytes=args.max_body_bytes,
    )
    LOGGER.info("serving %s on http://%s:%d (bucket %d, wait %.0f ms, %s)",
                args.task, *server.server_address, args.bucket, args.max_wait_ms, model.device)
    return server, engine


def main(argv=None):
    server, engine = serve(argv)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
        server.server_close()
        engine.shutdown()


if __name__ == "__main__":
    main()
