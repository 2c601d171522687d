"""Video in and weights in: ``valor_tpu_torch.cli.infer``, ``cli.extract``,
serving's ``video_path`` featurizer and ``--checkpoint``, against ``valor_tpu``
(CPU, the tiny config in fp32).

The tests need no ffmpeg: ``data/synthetic.py:write_ffmpeg_stand_in`` puts a
stand-in at the front of ``PATH`` for both packages, and
``write_video_clip`` writes clips in its container.  The weights are one JAX
init of ``cap%tva`` (the JAX CLI's own, kernels scaled by 8 so that captions
depend on their media), saved as a JAX run directory by JAX's ``ModelSaver``
and as the port's by its own (``params_from_jax``).  Tolerances: printed
captions and frame pixels exactly (both packages build the same decoder;
tests/test_torch_native.py), spectrograms 1e-5.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_data import TINY_VOCAB
from tests.test_torch_cli import TINY
from tests.test_torch_models import _np
from valor_tpu_torch.data.synthetic import write_ffmpeg_stand_in, write_video_clip

TASK = "cap%tva"


@pytest.fixture
def env(tmp_path, monkeypatch):
    """A config, a vocabulary, the ffmpeg stand-in on ``PATH``, two clips
    (one silent), an image, and the same weights as a JAX and a port run
    directory."""
    import valor_tpu.cli.build as JB
    from valor_tpu.core.config import load_config as jload
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel
    from valor_tpu.train.checkpoints import ModelSaver as JSaver
    from valor_tpu_torch.cli import serve as S
    from valor_tpu_torch.models.bridge import params_from_jax
    from valor_tpu_torch.train.checkpoints import ModelSaver

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(TINY_VOCAB))
    monkeypatch.setattr(JB, "DEFAULT_BERT_VOCAB", str(vocab))
    monkeypatch.setattr(S, "DEFAULT_BERT_VOCAB", str(vocab))
    monkeypatch.setenv("VALOR_BERT_VOCAB", str(vocab))
    bin_dir = tmp_path / "bin"
    write_ffmpeg_stand_in(str(bin_dir))
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    config = tmp_path / "config.json"
    config.write_text(json.dumps(TINY))
    clips = tmp_path / "clips"
    clips.mkdir()
    write_video_clip(str(clips / "a.mp4"), seconds=3.0, size=(64, 48), seed=1, tone_hz=330.0)
    write_video_clip(str(clips / "b.mkv"), seconds=2.0, size=(56, 40), seed=2, silent=True)
    (clips / "notes.txt").write_text("not a video")
    image = tmp_path / "im.jpg"
    Image.fromarray(np.random.RandomState(3).randint(0, 256, (40, 50, 3), dtype=np.uint8)).save(image)

    # the JAX CLI's own init (cli/infer.py), kernels scaled so captions depend on the media
    cfg = jload(str(config)).model
    model = VALORModel(cfg)
    batch = {"video_pixels": np.zeros((1, 8, 32, 32, 3), np.float32),
             "audio_spectrograms": np.zeros((1, 2, 16, 32), np.float32),
             "bert_tokens": np.asarray([[101, 102]], np.int32), "clip_tokens": np.asarray([[101, 102]], np.int32)}
    params = model.init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, batch,
                        parse_task(TASK), True, False)["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 8 if path[-1].key == "kernel" else x, params)
    JSaver(str(tmp_path / "jax_run"), remove_before_ckpt=False).save(
        types.SimpleNamespace(params=params, opt_state={}, step=jnp.asarray(3)), 3)
    sd = params_from_jax(_np(params))
    ModelSaver(str(tmp_path / "port_run"), remove_before_ckpt=False).save(types.SimpleNamespace(
        model=types.SimpleNamespace(state_dict=lambda: sd),
        optimizer=types.SimpleNamespace(state_dict=lambda: {}), step=3), 3)
    return types.SimpleNamespace(root=tmp_path, config=str(config), clips=clips, image=str(image),
                                 vocab=str(vocab), jax_run=str(tmp_path / "jax_run"),
                                 port_run=str(tmp_path / "port_run"))


def _both(env, capsys, *argv):
    """The ``[g] caption`` lines of both packages' ``cli.infer`` on ``argv``."""
    from valor_tpu.cli.infer import main as jmain
    from valor_tpu_torch.cli.infer import main

    jmain(["--config", env.config, "--checkpoint", env.jax_run, *argv])
    want = capsys.readouterr().out.splitlines()
    result = main(["--config", env.config, "--checkpoint", env.port_run, "--device", "cpu", *argv])
    got = capsys.readouterr().out.splitlines()
    return want, got, result


@pytest.mark.parametrize("media,beam", [("image", "1"), ("image", "3"), ("video", "3"), ("silent_video", "1")])
def test_infer_prints_jax_s_captions(env, capsys, media, beam):
    path = {"image": ["--image_path", env.image], "video": ["--video_path", str(env.clips / "a.mp4")],
            "silent_video": ["--video_path", str(env.clips / "b.mkv")]}[media]
    want, got, result = _both(env, capsys, *path, "--task", "cap%tva%tv", "--beam_size", beam)
    assert [ln.split(" ")[0] for ln in want] == ["[tva]", "[tv]"]
    assert got == want
    assert set(result["seconds"]) == {"extract", "featurize", "build", "generate"}
    assert result["batch"]["video_pixels"].dtype == np.float32


def test_infer_captions_depend_on_the_weights_and_media(env, capsys):
    """The parity above is not vacuous: other media give other sequences."""
    from valor_tpu_torch.cli.infer import main

    a = main(["--config", env.config, "--checkpoint", env.port_run, "--device", "cpu", "--beam_size", "1",
              "--video_path", str(env.clips / "a.mp4")])
    b = main(["--config", env.config, "--checkpoint", env.port_run, "--device", "cpu", "--beam_size", "1",
              "--image_path", env.image])
    assert not np.array_equal(a["sequences"]["tva"], b["sequences"]["tva"])


def test_infer_question_matches_jax(env, capsys):
    want, got, result = _both(env, capsys, "--image_path", env.image, "--task", "qa%tva",
                              "--question", "what does the cat sit on", "--beam_size", "1")
    assert got == want and len(got) == 1
    q = result["batch"]["question_prompt"][0]
    assert q[0] == 101 and q[-1] == 102


def test_infer_video_frames_are_the_jax_mapper_s(env, capsys):
    """The one-item batch of a video: frames through the C++ decoder of each
    package, equal bit for bit, and host log-mel clips equal to JAX's."""
    import tempfile

    from valor_tpu.cli.infer import extract_frames_and_wav as jextract
    from valor_tpu.data.pipeline import AudioMapper as JAudio
    from valor_tpu.data.pipeline import VideoMapper as JVideo
    from valor_tpu_torch.cli.infer import main
    from valor_tpu_torch.data import native

    calls = native.CALLS
    result = main(["--config", env.config, "--device", "cpu", "--video_path", str(env.clips / "a.mp4"),
                   "--video_sample_num", "3", "--beam_size", "1"])
    assert native.CALLS == calls + 1
    with tempfile.TemporaryDirectory() as tmp:
        jextract(str(env.clips / "a.mp4"), tmp)
        assert sorted(os.listdir(os.path.join(tmp, "frames"))) == [f"img_{i:04d}.jpg" for i in (1, 2, 3)]
        video = JVideo(tmp, resolution=32, sample_num=3, training=False)["frames"]
        audio = JAudio(tmp, sample_num=2, melbins=16, target_length=32, training=False)["audio"]
    np.testing.assert_array_equal(result["batch"]["video_pixels"][0], video)
    np.testing.assert_allclose(result["batch"]["audio_spectrograms"][0], audio, rtol=1e-5, atol=1e-5)


def test_infer_with_task_prompts_passes_the_caption_prompt(env, tmp_path, capsys):
    """F6 (kept on purpose): with ``use_task_prompt`` the port's ``cli.infer``
    decodes with the caption prompt, as serving and evaluation do; the JAX
    CLI passes none."""
    from valor_tpu_torch.cli.infer import main
    from valor_tpu_torch.data.prompts import PromptTable
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.models.bridge import load_model
    from valor_tpu_torch.cli.build import model_weights
    from valor_tpu_torch.core.config import load_config

    config = tmp_path / "prompted.json"
    config.write_text(json.dumps({**TINY, "use_task_prompt": True}))
    result = main(["--config", str(config), "--checkpoint", env.port_run, "--device", "cpu",
                   "--image_path", env.image, "--beam_size", "1"])
    caption = PromptTable(bert_tokenizer=BertTokenizer(env.vocab)).caption()
    np.testing.assert_array_equal(result["batch"]["prompt_tokens_caption"], caption)
    cfg = load_config(str(config)).model
    model = load_model(cfg, model_weights(cfg, env.port_run, "cpu"), "cpu")
    batch = {k: v for k, v in result["batch"].items() if k != "prompt_tokens_caption"}
    gen = Generator(model)
    prompted = gen.generate(dict(batch, prompt_tokens_caption=caption), ("tva",), max_len=4)
    np.testing.assert_array_equal(result["sequences"]["tva"], prompted["generated_sequences_tva"][0].numpy())


@pytest.mark.parametrize("cli", ["infer", "serve"])
def test_a_checkpoint_without_a_run_raises(env, cli):
    """F5's serving half: ``--checkpoint`` naming no run directory, or one
    without ``ckpt/step_N``, raises ``FileNotFoundError`` naming the path (the
    JAX CLIs go on with random weights)."""
    from valor_tpu_torch.cli import infer, serve

    (env.root / "empty").mkdir()
    for missing in (env.root / "empty", env.root / "typo"):
        argv = ["--config", env.config, "--checkpoint", str(missing), "--device", "cpu"]
        with pytest.raises(FileNotFoundError, match=str(missing)):
            if cli == "infer":
                infer.main(argv + ["--image_path", env.image])
            else:
                serve.serve(argv + ["--port", "0"])


def test_extract_writes_jax_s_tree_and_train_reads_it(env):
    from valor_tpu.cli.extract import main as jmain
    from valor_tpu_torch.cli.extract import main
    from valor_tpu_torch.data.pipeline import AudioMapper, VideoMapper

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                for d, _, fs in os.walk(root) for f in fs}

    jmain(["--video_dir", str(env.clips), "--out_dir", str(env.root / "jax_out"), "--workers", "2"])
    main(["--video_dir", str(env.clips), "--out_dir", str(env.root / "port_out"), "--workers", "2"])
    want, got = tree(env.root / "jax_out"), tree(env.root / "port_out")
    assert sorted(got) == sorted(want)
    assert got == want
    assert sorted(got) == ["audio_22050hz/a.wav"] + [f"frames_fps4/{v}/img_{i:04d}.jpg" for v, n in
                                                     (("a", 12), ("b", 8)) for i in range(1, n + 1)]
    out = env.root / "port_out"
    video = VideoMapper(str(out / "frames_fps4"), resolution=32, sample_num=4, transforms="crop_flip",
                        training=True, output_uint8=True)
    audio = AudioMapper(str(out / "audio_22050hz"), sample_num=1, melbins=16, target_length=32,
                        training=True, device_fbank=True)
    assert video["a"].shape == (4, 32, 32, 3) and video["b"].shape == (4, 32, 32, 3)
    a, b = audio["a"], audio["b"]
    assert np.abs(a["waveforms"]).max() > 0 and (a["valid_frames"] > 0).all()
    assert (b["valid_frames"] == -1).all()  # b is silent: no WAV, a missing-audio row


def _featurize_both(env, payload):
    from valor_tpu.cli.serve import _production_featurize
    from valor_tpu.core.config import load_config as jload
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JBert
    from valor_tpu_torch.cli.serve import production_featurizer
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer

    want = _production_featurize(jload(env.config), JBert(env.vocab), None)(payload)
    got = production_featurizer(load_config(env.config).model, BertTokenizer(env.vocab))(payload)
    return want, got


@pytest.mark.parametrize("payload", [{}, {"video_sample_num": 3, "audio_sample_num": 1},
                                     {"question": "what is on the mat"}])
def test_video_featurizer_matches_jax(env, payload):
    want, got = _featurize_both(env, {"video_path": str(env.clips / "a.mp4"), **payload})
    assert got.keys() == want.keys()
    assert got["video_pixels"].dtype == np.uint8
    assert got["video_pixels"].shape[0] == payload.get("video_sample_num", 8)
    np.testing.assert_array_equal(got["video_pixels"], want["video_pixels"])
    np.testing.assert_allclose(got["audio_spectrograms"], want["audio_spectrograms"], rtol=1e-5, atol=1e-5)
    if "question" in payload:
        np.testing.assert_array_equal(got["question_prompt"], want["question_prompt"])


def test_video_featurizer_errors_are_client_errors(env):
    from valor_tpu_torch.cli.serve import production_featurizer
    from valor_tpu_torch.core.config import load_config

    featurize = production_featurizer(load_config(env.config).model)
    with pytest.raises(FileNotFoundError, match="typo"):
        featurize({"video_path": str(env.root / "typo.mp4")})
    with pytest.raises(FileNotFoundError, match="notes.txt"):
        featurize({"video_path": str(env.clips / "notes.txt")})  # ffmpeg cannot read it
    silent = featurize({"video_path": str(env.clips / "b.mkv")})
    assert not silent["audio_spectrograms"].any()  # no audio stream: zero spectrograms
    with pytest.raises(ValueError, match="video_path or image_path"):
        featurize({})


def test_http_video_with_checkpoint(env):
    """``serve`` with ``--checkpoint``: a ``video_path`` request's caption
    equals a direct ``Generator.generate`` on its featurized item with the
    run's weights; a missing video is a 400."""
    import urllib.error
    import urllib.request

    from valor_tpu_torch.cli import serve as S
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.generate import Generator
    from valor_tpu_torch.eval.validate import decode_sequence

    server, engine = S.serve(["--config", env.config, "--checkpoint", env.port_run, "--device", "cpu",
                              "--port", "0", "--bucket", "4", "--max_wait_ms", "5"])
    try:
        base = "http://%s:%d" % server.server_address

        def post(payload):
            req = urllib.request.Request(base + "/generate", data=json.dumps(payload).encode())
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        payload = {"video_path": str(env.clips / "a.mp4")}
        code, out = post(payload)
        assert code == 200
        item = S.production_featurizer(engine.model.cfg)(payload)
        direct = Generator(engine.model).generate({k: v[None] for k, v in item.items()}, ("tva",),
                                                  max_len=TINY["max_generation_len"])
        seq = direct["generated_sequences_tva"][0].numpy()
        assert out["text"] == decode_sequence(BertTokenizer(env.vocab), seq)
        code, out = post({"video_path": str(env.root / "missing.mp4")})
        assert code == 400 and "missing.mp4" in out["error"]
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    # the served weights are the run's
    from valor_tpu_torch.cli.train import restore_weights

    saved = restore_weights(env.port_run)["params"]
    assert all(torch.equal(v, saved[k]) for k, v in engine.model.state_dict().items() if k in saved)
