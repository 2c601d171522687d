"""Serving path of the PyTorch port: engine, HTTP frontend, featurizer, and the
package's boundaries.

Mirrors a subset of tests/test_serve.py on the tiny model in fp32 on the
CPU: a request's result equals the same row of a direct ``Generator.generate``
call at the engine's bucket size, since rows are independent in the decode.
Also: no module of ``valor_tpu_torch`` imports JAX, flax or ``valor_tpu``, and
the entry points refuse to run without CUDA unless asked for the CPU.
"""

import ast
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_data import TINY_VOCAB
from tests.test_torch_models import torch_config
from tests.conftest import tiny_model_config
from valor_tpu_torch.cli.serve import production_featurizer, start_server
from valor_tpu_torch.eval.generate import Generator
from valor_tpu_torch.models.bridge import init_params, load_model
from valor_tpu_torch.serve import EngineOverloaded, InferenceEngine, ServeConfig

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    cfg = torch_config(tiny_model_config())
    model = load_model(cfg, init_params(cfg, seed=3, device="cpu"), "cpu")
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 256, size=(4, 2, 32, 32, 3), dtype=np.uint8)
    return model, pixels


def _direct(model, pixels, max_len=5):
    out = Generator(model).generate({"video_pixels": pixels}, ("tv",), max_len=max_len)
    return out["generated_sequences_tv"].numpy()


class TestEngine:
    def test_results_match_direct_generate(self, tiny):
        model, pixels = tiny
        direct = _direct(model, pixels)
        cfg = ServeConfig(buckets=(4,), max_wait_ms=-1, group="tv", max_len=5)
        with InferenceEngine(model, cfg) as eng:
            futs = [eng.submit({"video_pixels": p}) for p in pixels]
            results = [f.result(timeout=120) for f in futs]
        for i, r in enumerate(results):
            np.testing.assert_array_equal(r["sequences"], direct[i])
            assert r["batch_size"] == 4 and r["bucket"] == 4
        s = eng.stats()
        assert s["requests"] == 4 and s["batches"] == 1
        assert s["pad_fraction"] == 0.0 and s["mean_occupancy"] == 1.0
        assert s["decoders"] == {str(("decode", "unimlm", 5, 1, "greedy")): 1}
        assert set(s["batch_phase_mean_s"]) == {"assemble", "h2d", "device", "fanout"}

    def test_bucket_padding_and_slicing(self, tiny):
        model, pixels = tiny
        padded = np.stack([pixels[0], pixels[1], pixels[2], pixels[0]])
        direct = _direct(model, padded)
        cfg = ServeConfig(buckets=(1, 4), max_wait_ms=200, group="tv", max_len=5)
        with InferenceEngine(model, cfg) as eng:
            futs = [eng.submit({"video_pixels": pixels[i]}) for i in range(3)]
            results = [f.result(timeout=120) for f in futs]
        s = eng.stats()
        assert s["batches"] == 1 and s["rows_run"] == 4 and s["rows_real"] == 3
        assert s["pad_fraction"] == pytest.approx(0.25)
        for i, r in enumerate(results):
            np.testing.assert_array_equal(r["sequences"], direct[i])

    def test_lanes_do_not_mix(self, tiny):
        model, pixels = tiny
        cfg = ServeConfig(buckets=(1, 4), max_wait_ms=20, group="tv", max_len=5)
        with InferenceEngine(model, cfg) as eng:
            f5 = eng.submit({"video_pixels": pixels[0]})
            f7 = eng.submit({"video_pixels": pixels[1]}, max_len=7)
            r5, r7 = f5.result(timeout=120), f7.result(timeout=120)
        assert r5["sequences"].shape == (5,) and r7["sequences"].shape == (7,)
        assert eng.stats()["batches"] == 2

    def test_back_to_back_batches_and_concurrent_submitters(self, tiny):
        model, pixels = tiny
        direct = _direct(model, pixels[:2])
        cfg = ServeConfig(buckets=(2,), max_wait_ms=-1, group="tv", max_len=5)
        results = {}
        with InferenceEngine(model, cfg) as eng:
            def worker(i):
                results[i] = eng.generate({"video_pixels": pixels[i % 2]})["sequences"]

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
            [t.start() for t in threads]
            [t.join(timeout=120) for t in threads]
        assert not any(t.is_alive() for t in threads)
        for i in range(6):
            np.testing.assert_array_equal(results[i], direct[i % 2])
        assert eng.stats()["batches"] == 3

    def test_bad_items_and_run_errors(self, tiny):
        model, pixels = tiny
        cfg = ServeConfig(buckets=(1, 4), max_wait_ms=0, group="tv", max_len=5)
        with InferenceEngine(model, cfg) as eng:
            with pytest.raises(KeyError):
                eng.submit({"video_pixel": pixels[0]})
            with pytest.raises(ValueError):
                eng.submit({"video_pixels": pixels[0, 0]})  # rank 3
            with pytest.raises(ValueError):
                eng.submit({})
            # wrong resolution fails in the worker: delivered to this future only
            bad = eng.submit({"video_pixels": np.zeros((2, 16, 16, 3), np.float32)})
            with pytest.raises(Exception):
                bad.result(timeout=120)
            ok = eng.submit({"video_pixels": pixels[0]})
            assert ok.result(timeout=120)["sequences"].shape == (5,)

    def test_overload_sheds_and_shutdown_drains(self, tiny):
        model, pixels = tiny
        cfg = ServeConfig(buckets=(4,), max_wait_ms=-1, group="tv", max_len=5, max_pending=3)
        eng = InferenceEngine(model, cfg)
        try:
            futs = [eng.submit({"video_pixels": pixels[i]}) for i in range(3)]
            with pytest.raises(EngineOverloaded):
                eng.submit({"video_pixels": pixels[3]})
            s = eng.stats()
            assert s["shed"] == 1 and s["queue_depth"] == 3
        finally:
            eng.shutdown()  # drain launches the partial batch
        for f in futs:
            assert f.result(timeout=0)["sequences"].shape == (5,)
        with pytest.raises(RuntimeError):
            eng.submit({"video_pixels": pixels[0]})


class _SlowResult:
    """A decode result whose read takes ``delay`` seconds, as reading a batch
    that is still on the card does; the launch itself returns at once."""

    def __init__(self, arr, delay):
        self.arr, self.delay = arr, delay

    def cpu(self):
        time.sleep(self.delay)
        return torch.from_numpy(self.arr)


class _FakeGenerator:
    def __init__(self, device_s):
        self.device_s = device_s

    def generate(self, batch, groups, max_len, **kw):
        rows = next(iter(batch.values())).shape[0]
        g = groups[0]
        return {f"generated_sequences_{g}": _SlowResult(np.zeros((rows, max_len), np.int32), self.device_s),
                f"logprobs_{g}": _SlowResult(np.zeros((rows, max_len), np.float32), 0.0)}

    def stats(self):
        return {}


class TestEngineFaults:
    """Two faults of the engine's batching loop, fixed in the port (ROADMAP F2)."""

    def test_trickling_lane_launches_within_max_wait_plus_one_cycle(self, tiny):
        """A hot lane kept at one full batch plus one keeps the device busy,
        while a cold lane gets one request every 100 ms, less than one 200 ms
        device cycle: the cold lane never stops growing and never fills its
        16 rows, so without the age backstop it waits until the hot traffic
        ends.  Each request must launch within max_wait_ms plus one cycle,
        plus one cycle until the next pick, and is read two cycles after its
        launch (double buffering)."""
        model, pixels = tiny
        device_s, max_wait = 0.2, 0.05
        cfg = ServeConfig(buckets=(1, 16), max_wait_ms=max_wait * 1e3, group="tv", max_len=5)
        eng = InferenceEngine(model, cfg)
        eng._gen = _FakeGenerator(device_s)
        stop = threading.Event()
        hot, cold = [], []

        def hot_queued():
            with eng._lock:  # the hot lane's queue (max_len 5; the cold lane's is 7)
                return sum(len(lane) for key, lane in eng._lanes.items() if key[3] == 5)

        def hot_client():  # saturated, not overloaded: the lane never holds 2 batches
            while not stop.is_set():
                if hot_queued() < 17:
                    hot.append(eng.submit({"video_pixels": pixels[0]}))
                else:
                    time.sleep(0.005)

        def cold_client():
            for _ in range(15):
                cold.append(eng.submit({"video_pixels": pixels[1]}, max_len=7))
                time.sleep(0.1)

        threads = [threading.Thread(target=hot_client), threading.Thread(target=cold_client)]
        try:
            [t.start() for t in threads]
            threads[1].join(timeout=30)
            time.sleep(1.0)  # the hot lane stays saturated past the last cold request
        finally:
            stop.set()
            threads[0].join(timeout=30)
            eng.shutdown()
        lat = [f.result(timeout=30)["latency_s"] for f in cold]
        # wait, backstop cycle, pick cycle, two-cycle read, and one cycle of slack
        bound = max_wait + 5 * device_s + 0.15
        assert max(lat) <= bound, (max(lat), bound)
        assert all(f.result(timeout=30)["sequences"].shape == (5,) for f in hot)

    def test_thousands_of_cancelled_lanes_do_not_recurse(self, tiny):
        """1500 single-request lanes, all cancelled while queued, then one live
        request: the picker drops the dead lanes in a loop (a recursive retry
        overflows Python's stack) and serves the live one."""
        model, pixels = tiny
        # max_wait_ms outlasts submitting and cancelling the 1500 lanes on a loaded
        # machine: a lane that aged out before its cancel would launch a batch
        cfg = ServeConfig(buckets=(4,), max_wait_ms=5000, group="tv", max_len=5, max_pending=0)
        eng = InferenceEngine(model, cfg)
        eng._gen = _FakeGenerator(0.0)
        try:
            dead = [eng.submit({"video_pixels": pixels[0]}, max_len=10 + i) for i in range(1500)]
            assert all(f.cancel() for f in dead)
            live = eng.submit({"video_pixels": pixels[1]})
            assert live.result(timeout=30)["sequences"].shape == (5,)
        finally:
            eng.shutdown()
        assert eng.stats()["batches"] == 1 and eng.stats()["queue_depth"] == 0


def _post(server, payload, raw=None):
    host, port = server.server_address
    req = urllib.request.Request(
        f"http://{host}:{port}/generate",
        data=raw if raw is not None else json.dumps(payload).encode(),
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestHTTP:
    def test_roundtrip_stats_and_error_codes(self, tiny):
        model, pixels = tiny
        direct = _direct(model, pixels[:1])[0]

        def featurize(payload):
            if payload.get("boom"):
                raise OSError("backend exploded")  # internal -> 500
            return {"video_pixels": pixels[int(payload["row"])]}

        def decode(seq):
            return " ".join(str(int(t)) for t in seq)

        cfg = ServeConfig(buckets=(1, 4), max_wait_ms=5, group="tv", max_len=5)
        with InferenceEngine(model, cfg) as eng:
            server = start_server(eng, featurize, decode, port=0, max_body_bytes=200)
            try:
                host, port = server.server_address
                code, out = _post(server, {"row": 0})
                assert code == 200 and out["text"] == decode(direct)
                assert out["bucket"] in (1, 4)
                with urllib.request.urlopen(f"http://{host}:{port}/healthz") as r:
                    assert json.loads(r.read()) == {"ok": True}
                with urllib.request.urlopen(f"http://{host}:{port}/stats") as r:
                    stats = json.loads(r.read())
                assert stats["requests"] >= 1 and stats["batches"] >= 1
                assert _post(server, {"no_row": True})[0] == 400
                assert _post(server, {"row": "not-an-int"})[0] == 400
                assert _post(server, None, raw=b"{not json")[0] == 400
                code, out = _post(server, {"boom": True})
                assert code == 500 and "OSError" in out["error"]
                code, out = _post(server, {"row": 0, "pad": "x" * 1000})
                assert code == 413 and "limit" in out["error"]
            finally:
                server.shutdown()
                server.server_close()

    def test_overload_returns_503(self, tiny):
        model, pixels = tiny
        cfg = ServeConfig(buckets=(4,), max_wait_ms=-1, group="tv", max_len=5, max_pending=1)
        eng = InferenceEngine(model, cfg)
        server = start_server(eng, lambda p: {"video_pixels": pixels[int(p["row"])]},
                              lambda s: "x", port=0)
        first = {}
        t = threading.Thread(target=lambda: first.update(resp=_post(server, {"row": 0})))
        try:
            t.start()
            for _ in range(500):  # wait until the parked request is queued
                if eng.stats()["queue_depth"] >= 1:
                    break
                time.sleep(0.01)
            code, out = _post(server, {"row": 1})
            assert code == 503 and out.get("retry") is True
        finally:
            server.shutdown()
            server.server_close()
            eng.shutdown()  # drain launches the parked partial batch
            t.join(timeout=120)
        assert first["resp"][0] == 200


def test_image_featurizer_matches_jax_mapper(tmp_path):
    from valor_tpu.data.pipeline import VideoMapper

    cfg = tiny_model_config()
    rng = np.random.RandomState(1)
    Image.fromarray(rng.randint(0, 256, (45, 61, 3), dtype=np.uint8)).save(tmp_path / "im.jpg")
    ref = VideoMapper(str(tmp_path), resolution=32, sample_num=1, datatype="image",
                      encoder_type=cfg.video_encoder_type, training=False, output_uint8=True)["im.jpg"]
    item = production_featurizer(torch_config(cfg))({"image_path": str(tmp_path / "im.jpg")})
    np.testing.assert_array_equal(item["video_pixels"], ref)
    assert item["audio_spectrograms"].shape == (2, 16, 32)
    with pytest.raises(FileNotFoundError, match="clip.mp4"):  # video_path is served: a missing one is a 400
        production_featurizer(torch_config(cfg))({"video_path": "clip.mp4"})
    with pytest.raises(RuntimeError, match="tokenizer"):  # a question needs the server's tokenizer
        production_featurizer(torch_config(cfg))({"image_path": str(tmp_path / "im.jpg"), "question": "what?"})
    with pytest.raises(FileNotFoundError):
        production_featurizer(torch_config(cfg))({"image_path": str(tmp_path / "missing.jpg")})


def _tokenizers(tmp_path):
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JTok
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer as TTok

    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    return JTok(str(tmp_path / "vocab.txt")), TTok(str(tmp_path / "vocab.txt"))


@pytest.mark.parametrize("pad", [None, 12])
def test_question_featurizer_matches_jax(tmp_path, pad):
    """A question's prompt, ``[CLS] q [SEP]`` padded to ``question_pad``, equals
    the JAX featurizer's, beside the same frame."""
    from valor_tpu.cli.serve import _production_featurize
    from valor_tpu.core.config import Config

    cfg = tiny_model_config()
    Image.fromarray(np.random.RandomState(2).randint(0, 256, (40, 50, 3), dtype=np.uint8)).save(
        tmp_path / "im.jpg")
    jtok, ttok = _tokenizers(tmp_path)
    payload = {"image_path": str(tmp_path / "im.jpg"), "question": "What is the cat on?"}
    if pad:
        payload["question_pad"] = pad
    ref = _production_featurize(Config(model=cfg), jtok)(payload)
    item = production_featurizer(torch_config(cfg), ttok)(payload)
    assert item.keys() == ref.keys()
    for k in ref:
        assert item[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(item[k], ref[k], err_msg=k)
    assert item["question_prompt"].shape == (pad or 32,) and item["question_prompt"][0] == 101


def test_long_question_keeps_every_token(tmp_path):
    """A 40-token question is not cut at ``question_pad``: every token and the
    closing [SEP] survive, padded to a multiple of 8 (the JAX featurizer keeps
    the first 32 ids and loses [SEP])."""
    from valor_tpu_torch.cli.serve import question_prompt

    _, tok = _tokenizers(tmp_path)
    question = " ".join(["the cat sits on a mat"] * 7)[: len("the cat sits on a mat") * 7]
    ids = tok.encode(question)[:38]
    question = tok.decode(ids)
    assert len(tok.encode(question)) == 38
    q = question_prompt(tok, question)
    assert q.shape == (40,) and q.dtype == np.int32
    np.testing.assert_array_equal(q, [101] + ids + [102])
    assert question_prompt(tok, question + " cat").shape == (48,)  # 41 ids -> 48
    assert question_prompt(tok, "a cat", pad=32).shape == (32,)


@pytest.mark.parametrize("arch", [{"fusion_moe_experts": 4, "fusion_moe_every": 2},
                                  {"fusion_cross_attn_kv_heads": 1}], ids=["moe", "gqa"])
def test_engine_serves_the_moe_and_gqa_configs(arch):
    """The engine needs nothing of its own for MoE fusion layers or
    grouped-query cross-attention: served rows equal a direct decode (which
    equals JAX's, tests/test_torch_moe.py and tests/test_torch_gqa.py)."""
    cfg = torch_config(tiny_model_config(**arch))
    model = load_model(cfg, init_params(cfg, seed=3, device="cpu"), "cpu")
    pixels = np.random.RandomState(1).randint(0, 256, size=(4, 2, 32, 32, 3), dtype=np.uint8)
    direct = _direct(model, pixels)
    with InferenceEngine(model, ServeConfig(buckets=(4,), max_wait_ms=-1, group="tv", max_len=5)) as eng:
        results = [f.result(timeout=120) for f in [eng.submit({"video_pixels": p}) for p in pixels]]
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r["sequences"], direct[i])


def test_serve_main_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """A ``--checkpoint`` that holds no ``ckpt/step_N`` is an error naming the
    path, never random weights served (F5's serving half: the JAX package
    serves random weights there)."""
    from tests.test_torch_cli import TINY
    from valor_tpu_torch.cli import serve as S

    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    monkeypatch.setattr(S, "DEFAULT_BERT_VOCAB", str(tmp_path / "vocab.txt"))
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    (tmp_path / "run").mkdir()
    for missing in (tmp_path / "run", tmp_path / "typo"):
        with pytest.raises(FileNotFoundError, match=str(missing)):
            S.main(["--config", str(tmp_path / "config.json"), "--checkpoint", str(missing), "--device", "cpu"])


def test_prompted_question_featurizer_matches_jax(tmp_path):
    """With ``use_task_prompt`` the question prompt is ``[CLS] body q [SEP]``
    (the QA prompt's body spliced after [CLS]), equal to the JAX featurizer's."""
    from valor_tpu.cli.serve import _production_featurize
    from valor_tpu.core.config import Config
    from valor_tpu.data.prompts import PromptTable as JTable
    from valor_tpu_torch.data.prompts import PromptTable

    cfg = tiny_model_config(use_task_prompt=True)
    Image.fromarray(np.random.RandomState(2).randint(0, 256, (40, 50, 3), dtype=np.uint8)).save(
        tmp_path / "im.jpg")
    jtok, ttok = _tokenizers(tmp_path)
    jtable, ttable = JTable(bert_tokenizer=jtok), PromptTable(bert_tokenizer=ttok)
    payload = {"image_path": str(tmp_path / "im.jpg"), "question": "What is the cat on?"}
    ref = _production_featurize(Config(model=cfg), jtok, jtable)(payload)
    item = production_featurizer(torch_config(cfg), ttok, ttable)(payload)
    np.testing.assert_array_equal(item["question_prompt"], ref["question_prompt"])
    body = ttable.qa_body()[0].tolist()
    assert item["question_prompt"][1 : 1 + len(body)].tolist() == body
    np.testing.assert_array_equal(item["question_prompt"][: 2 + len(body)][-1:],
                                  [ttok.encode("what")[0]])


def test_serve_main_serves_prompts(tmp_path, monkeypatch):
    """A config with ``use_task_prompt``: ``main`` gives the engine the caption
    prompt of the decode group and the featurizer the QA prompt's body, and a
    served caption equals a direct ``Generator.generate`` with that prompt."""
    import valor_tpu_torch.cli.serve as S
    from tests.test_torch_cli import TINY
    from valor_tpu_torch.data.prompts import PromptTable
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer

    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    monkeypatch.setattr(S, "DEFAULT_BERT_VOCAB", str(tmp_path / "vocab.txt"))
    (tmp_path / "config.json").write_text(json.dumps({**TINY, "use_task_prompt": True}))
    served = {}

    class Server:
        server_address = ("127.0.0.1", 0)

        def shutdown(self):
            served["shutdown"] = True

        def server_close(self):
            pass

    event = threading.Event

    def start(engine, featurize, decode, **kw):
        served.update(engine=engine, featurize=featurize)
        threading.Event = Stop  # main waits on an Event after starting the server
        return Server()

    class Stop:
        def wait(self):
            threading.Event = event
            item = {"video_pixels": np.random.RandomState(4).randint(0, 256, (1, 32, 32, 3), dtype=np.uint8),
                    "audio_spectrograms": np.zeros((2, 16, 32), np.float32)}
            served["item"] = item
            served["result"] = served["engine"].submit(item).result(timeout=120)
            raise KeyboardInterrupt

    monkeypatch.setattr(S, "start_server", start)
    monkeypatch.setattr(threading, "Event", event)  # restored whatever happens
    S.main(["--config", str(tmp_path / "config.json"), "--device", "cpu", "--task", "cap%tva"])
    engine = served["engine"]
    caption = PromptTable(bert_tokenizer=BertTokenizer(str(tmp_path / "vocab.txt"))).caption()
    assert set(engine.prompts) == {"tva"}
    np.testing.assert_array_equal(engine.prompts["tva"], caption)
    item = dict(served["item"])
    batch = {k: v[None] for k, v in item.items()}
    direct = Generator(engine.model).generate(dict(batch, prompt_tokens_caption=caption), ("tva",),
                                              max_len=TINY["max_generation_len"])
    np.testing.assert_array_equal(served["result"]["sequences"], direct["generated_sequences_tva"][0].numpy())
    unprompted = Generator(engine.model).generate(batch, ("tva",), max_len=TINY["max_generation_len"])
    assert served["shutdown"] and unprompted["generated_sequences_tva"].shape == (1, 4)


def test_decode_sequence(tmp_path):
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.validate import decode_sequence

    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    tok = BertTokenizer(str(tmp_path / "vocab.txt"))
    ids = tok.encode("the cat sits on the mat")
    assert decode_sequence(tok, np.asarray(ids + [102, 107, 108])) == "the cat sits on the mat"


def _port_sources():
    return sorted((REPO / "valor_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax(path):
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "valor_tpu")
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path}: imports {name}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from valor_tpu_torch.models.valor import VALORModel

    cfg = torch_config(tiny_model_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VALORModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, seed=0)
    sd = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(cfg, sd)
    assert load_model(cfg, sd, "cpu").device.type == "cpu"
    # one seed, one set of weights
    again = init_params(cfg, seed=0, device="cpu")
    assert sd.keys() == again.keys() and all(torch.equal(sd[k], again[k]) for k in sd)
