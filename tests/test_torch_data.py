"""Disk data path of the PyTorch port against ``valor_tpu.data`` (CPU).

The same seeded inputs and the same on-disk fixture (the recipe of
tests/test_data.py) go through both packages.  Tolerances, with their reasons:

  * the device fbank, torch against JAX and against ``fbank_np``: 1e-4
    absolute and relative on the normalised output (fp32 products summed in
    another order; near-silent frames turn a relative error of the power into
    an absolute one of its log); missing audio exactly 0;
  * every host module (tokenizers, mappers, resampler, collate, sampler and
    task orders) exactly: the port runs the same numpy and PIL code.

Both ``VideoMapper``s take their C++ decoder for ``transforms="none"`` where
the library loads; the PIL tests turn it off at run time (``monkeypatch``) in
both packages (tests/test_torch_native.py holds the two decoders together).  The prefetcher's tests are in
tests/test_torch_prefetch.py, which imports no JAX (its card test runs on a
machine without it).
"""

import json
import random
import threading
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_data import TINY_VOCAB
from valor_tpu.data import fbank as jfb
from valor_tpu.data import loader as jld
from valor_tpu.data import pipeline as jpl
from valor_tpu.data.resample import resample as jresample
from valor_tpu.data.tokenizers.clip_bpe import ClipBPETokenizer as JClip
from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JBert
from valor_tpu_torch.data import fbank as tfb
from valor_tpu_torch.data import loader as tld
from valor_tpu_torch.data import pipeline as tpl
from valor_tpu_torch.data.resample import resample as tresample
from valor_tpu_torch.data.synthetic import WORDS, write_tokenizer_files
from valor_tpu_torch.data.tokenizers.clip_bpe import ClipBPETokenizer as TClip
from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer as TBert

TOL = 1e-4
MEL, TLEN = 16, 32


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _spans(seed=0):
    """[3, 2, L] clip spans: noise, a tone, signal shorter than one window then
    zeros, loud noise, noise, a tone in faint noise; valid frames full, partial,
    1, 0, missing (-1) and full."""
    span = jfb.clip_span_samples(TLEN)
    rng = np.random.RandomState(seed)
    t = np.arange(span) / 22050
    short = np.zeros(span)
    short[:300] = rng.randn(300)
    waves = np.stack([
        0.3 * rng.randn(span), np.sin(2 * np.pi * 440 * t), short,
        rng.randn(span), rng.randn(span), 0.5 * np.sin(2 * np.pi * 3000 * t) + 0.01 * rng.randn(span),
    ]).astype(np.float32).reshape(3, 2, span)
    valid = np.array([[TLEN, 20], [1, 0], [-1, TLEN]], np.int32)
    return waves, valid


# -- fbank --------------------------------------------------------------------
def test_fbank_host_half_is_a_copy():
    for args in ((MEL, 1024, 22050.0), (64, 1024, 22050.0), (64, 512, 16000.0)):
        np.testing.assert_array_equal(tfb.mel_banks(*args), jfb.mel_banks(*args))
    for a, b in zip(tfb._dft_mel_basis(551, 1024, 64, 22050), jfb._dft_mel_basis(551, 1024, 64, 22050)):
        np.testing.assert_array_equal(a, b)
    wav = np.random.RandomState(3).randn(9000).astype(np.float32)
    np.testing.assert_array_equal(tfb.fbank_np(wav, 22050, MEL), jfb.fbank_np(wav, 22050, MEL))
    assert tfb.clip_span_samples(512) == jfb.clip_span_samples(512) == 112971


@pytest.mark.parametrize("n", [300, 551, 552, 8000])
def test_fbank_matches_jax(n):
    """Framing by unfold where n >= win, one clipped frame below it."""
    wav = np.random.RandomState(n).randn(n).astype(np.float32)
    out = tfb.fbank(torch.from_numpy(wav), 22050, MEL).numpy()
    ref = np.asarray(jfb.fbank(jnp.asarray(wav), 22050, MEL))
    assert out.shape == ref.shape == (max(1 + (n - 551) // 220, 1), MEL)
    _close(out, ref)


def test_fbank_clips_from_spans_matches_jax_and_host():
    waves, valid = _spans()
    out = tfb.fbank_clips_from_spans(torch.from_numpy(waves), torch.from_numpy(valid),
                                     melbins=MEL, target_length=TLEN).numpy()
    ref = np.asarray(jfb.fbank_clips_from_spans(jnp.asarray(waves), jnp.asarray(valid),
                                                melbins=MEL, target_length=TLEN))
    assert out.shape == (3, 2, MEL, TLEN) and out.dtype == np.float32
    _close(out, ref)
    np.testing.assert_array_equal(out[2, 0], 0.0)  # missing audio: exact zero
    np.testing.assert_allclose(out[1, 1], 4.2677393 / (2 * 4.5689974), rtol=1e-6)  # no valid frame
    for b in range(3):
        for c in range(2):
            host = tfb.fbank_np(waves[b, c], 22050, MEL)
            v = valid[b, c]
            host = np.where(np.arange(TLEN)[:, None] < max(v, 0), host, 0.0)
            host = (host + 4.2677393) / (2 * 4.5689974) * (v >= 0)
            _close(out[b, c], host.T)


@pytest.mark.parametrize("n_samples", [5000, 30000])
def test_fbank_clips_eval_matches_jax(n_samples):
    wav = np.random.RandomState(1).randn(n_samples).astype(np.float32)
    out = tfb.fbank_clips(torch.from_numpy(wav), 3, target_length=TLEN, melbins=MEL).numpy()
    ref = np.asarray(jfb.fbank_clips(jnp.asarray(wav), 3, target_length=TLEN, melbins=MEL))
    _close(out, ref)


def test_uniform_chunk_indices_eval_matches_jax():
    for total, n in ((1, 3), (7, 2), (10, 4), (4, 4)):
        assert tfb.uniform_chunk_indices(total, n, False) == np.asarray(
            jfb.uniform_chunk_indices(total, n, False, None)).tolist()
    picks = tfb.uniform_chunk_indices(10, 4, True, random.Random(0))
    assert [c for c, ch in zip(picks, tpl.uniform_chunks(list(range(10)), 4)) if c in ch] == picks


def test_fbank_restores_the_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        tfb.fbank(torch.randn(4000), 22050, MEL)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("rates", [(16000, 22050), (44100, 22050), (22050, 16000), (22050, 22050)])
def test_resample_matches_jax(rates):
    wav = np.random.RandomState(2).randn(7001).astype(np.float32)
    np.testing.assert_array_equal(tresample(wav, *rates), jresample(wav, *rates))


# -- tokenizers and text --------------------------------------------------------
@pytest.fixture(scope="module")
def tok_files(tmp_path_factory):
    return write_tokenizer_files(str(tmp_path_factory.mktemp("tok")))


def test_clip_bpe_matches_jax(tok_files):
    tok, ref = TClip(tok_files["merges"]), JClip(tok_files["merges"])
    assert (tok.sot_token, tok.eot_token) == (ref.sot_token, ref.eot_token)
    texts = [" ".join(WORDS), "A man's DOG runs, on the grass!", "cooking &amp; news 42", "zebra xylophone"]
    for s in texts:
        assert tok.encode(s) == ref.encode(s)
        assert tok.decode(tok.encode(s)) == ref.decode(ref.encode(s))
    assert len(tok.encode("kitchen")) == 1  # the merges build every word


def test_clip_bpe_merge_slice_matches_jax(tmp_path):
    """Only merges [1 : 49152 - 256 - 2 + 1] of the file are read."""
    lines = ["#version"] + [f"{chr(97 + i % 26)} {chr(97 + (i * 7) % 26)}" for i in range(49200)]
    path = tmp_path / "many.txt"
    path.write_text("\n".join(lines))
    tok, ref = TClip(str(path)), JClip(str(path))
    assert len(tok.bpe_ranks) == len(ref.bpe_ranks) and tok.encoder == ref.encoder
    assert tok.eot_token == ref.eot_token


@pytest.mark.parametrize("training,test_one", [(False, False), (False, True), (True, False)])
def test_txt_mapper_matches_jax(tmp_path, tok_files, training, test_one):
    (tmp_path / "v.txt").write_text("\n".join(TINY_VOCAB + [w for w in WORDS if w not in TINY_VOCAB]))
    txt = {"a": "A man  playing, the guitar!", "b": ["the dog runs on grass", "a cat sits"],
           "c": " ".join(WORDS)}
    (tmp_path / "txt.json").write_text(json.dumps(txt))
    mine = tpl.TxtMapper(str(tmp_path / "txt.json"), 6, TBert(str(tmp_path / "v.txt")),
                         TClip(tok_files["merges"]), training=training, test_one=test_one)
    ref = jpl.TxtMapper(str(tmp_path / "txt.json"), 6, JBert(str(tmp_path / "v.txt")),
                        JClip(tok_files["merges"]), training=training, test_one=test_one)
    for key in txt:
        random.seed(7)
        got = mine[key]
        random.seed(7)
        want = ref[key]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() == {"bert_tokens", "clip_tokens"}
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert tpl.clean_text("A  Cat,  sits!") == jpl.clean_text("A  Cat,  sits!")


# -- the on-disk fixture --------------------------------------------------------
@pytest.fixture
def fixture_dataset(tmp_path):
    """tests/test_data.py's fixture, with noisier frames and a 16 kHz wav."""
    ids = ["vid0", "vid1", "vid2", "vid3"]
    (tmp_path / "ids.json").write_text(json.dumps(ids))
    txts = {"vid0": "a cat sits", "vid1": ["the dog runs", "a mat"], "vid2": "the cat", "vid3": "a dog"}
    (tmp_path / "txt.json").write_text(json.dumps(txts))
    rng = np.random.RandomState(0)
    for vid in ids:
        d = tmp_path / "frames" / vid
        d.mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(d / f"img_{i:04d}.jpg")
    (tmp_path / "audio").mkdir()
    for vid, rate, n in (("vid0", 22050, 22050), ("vid1", 22050, 5000), ("vid3", 16000, 30000)):
        with wave.open(str(tmp_path / "audio" / f"{vid}.wav"), "wb") as w:  # vid2: no audio
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes((np.sin(np.arange(n) * 0.3) * 2e4 + rng.randn(n) * 500).astype("<i2").tobytes())
    return tmp_path


@pytest.fixture
def pil_only(monkeypatch):
    """Both mappers' PIL branch: the C++ decoder of each package turned off for
    this test (tests/test_torch_native.py holds the two decoders together)."""
    from valor_tpu.data import native
    from valor_tpu_torch.data import native as tnative

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.fixture
def seeded_random(monkeypatch):
    """Every ``random.Random()`` a mapper makes starts from seed 0, in both packages."""
    orig = random.Random
    monkeypatch.setattr(random, "Random", lambda *a: orig(0))


@pytest.mark.parametrize("transforms", ["crop_flip", "none"])
@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("training", [False, True])
def test_video_mapper_matches_jax_pil(fixture_dataset, pil_only, seeded_random, transforms, uint8, training):
    kw = dict(resolution=32, sample_num=3, transforms=transforms, training=training, output_uint8=uint8)
    mine = tpl.VideoMapper(str(fixture_dataset / "frames"), **kw)
    ref = jpl.VideoMapper(str(fixture_dataset / "frames"), **kw)
    for vid in ("vid0", "vid3"):
        got, want = mine[vid], ref[vid]
        assert got.shape == (3, 32, 32, 3) and got.dtype == (np.uint8 if uint8 else np.float32)
        np.testing.assert_array_equal(got, want)


def test_image_loader_matches_video_mapper(fixture_dataset, pil_only):
    path = str(fixture_dataset / "frames" / "vid1" / "img_0002.jpg")
    for transforms in ("crop_flip", "none"):
        ref = jpl.VideoMapper(str(fixture_dataset / "frames" / "vid1"), resolution=32, datatype="image",
                              transforms=transforms, training=False, output_uint8=True)["img_0002.jpg"]
        np.testing.assert_array_equal(tpl.load_image_uint8(path, 32, transforms), ref)


@pytest.mark.parametrize("device_fbank", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_audio_mapper_matches_jax(fixture_dataset, seeded_random, device_fbank, training):
    """Both branches; vid3 is a 16 kHz file (resampled to 22050 Hz), vid2 has none."""
    kw = dict(sample_num=2, melbins=MEL, target_length=TLEN, training=training, device_fbank=device_fbank)
    mine = tpl.AudioMapper(str(fixture_dataset / "audio"), **kw)
    ref = jpl.AudioMapper(str(fixture_dataset / "audio"), **kw)
    for vid in ("vid0", "vid1", "vid2", "vid3"):
        got, want = mine[vid], ref[vid]
        if device_fbank:
            assert got.keys() == want.keys() == {"waveforms", "valid_frames"}
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got.dtype == want.dtype and got.shape == (2, MEL, TLEN)
            np.testing.assert_array_equal(got, want)
    missing = mine["vid2"]
    np.testing.assert_array_equal(missing["valid_frames"] if device_fbank else missing,
                                  -1 if device_fbank else 0)


def test_load_wav_matches_jax(fixture_dataset, tmp_path):
    path = tmp_path / "w24.wav"
    with wave.open(str(path), "wb") as w:  # stereo 24-bit
        w.setnchannels(2)
        w.setsampwidth(3)
        w.setframerate(8000)
        w.writeframes(np.random.RandomState(5).randint(0, 256, 3 * 2 * 100, dtype=np.uint8).tobytes())
    for p in (str(fixture_dataset / "audio" / "vid3.wav"), str(path)):
        (a, sa), (b, sb) = tpl.load_wav(p), jpl.load_wav(p)
        assert sa == sb
        np.testing.assert_array_equal(a, b)


def _datasets(root, training, device_fbank, tok_path):
    out = []
    for P, Bert in ((tpl, TBert), (jpl, JBert)):
        txt = P.TxtMapper(str(root / "txt.json"), 6, Bert(tok_path), None, training=training)
        vid = P.VideoMapper(str(root / "frames"), resolution=32, sample_num=2, transforms="crop_flip",
                            training=training, output_uint8=True)
        aud = P.AudioMapper(str(root / "audio"), sample_num=2, melbins=MEL, target_length=TLEN,
                            training=training, device_fbank=device_fbank)
        out.append(P.VALORDataset(str(root / "ids.json"), txt, vid, aud, training))
    return out


@pytest.mark.parametrize("device_fbank", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_dataset_and_collate_match_jax(fixture_dataset, pil_only, seeded_random, tmp_path,
                                       device_fbank, training):
    (tmp_path / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    mine, ref = _datasets(fixture_dataset, training, device_fbank, str(tmp_path / "vocab.txt"))
    assert len(mine) == len(ref) == 4
    random.seed(3)
    got = tpl.valor_collate([mine[i] for i in range(4)])
    random.seed(3)
    want = jpl.valor_collate([ref[i] for i in range(4)])
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    assert ("audio_waveforms" in got) == device_fbank and ("audio_spectrograms" in got) != device_fbank


# -- loaders ------------------------------------------------------------------
@pytest.mark.parametrize("n,batch,shard,shards,shuffle", [
    (103, 10, 0, 1, True), (103, 10, 1, 4, True), (103, 10, 3, 4, False), (17, 4, 0, 1, False)])
def test_sharded_batch_sampler_matches_jax(n, batch, shard, shards, shuffle):
    mine = tld.ShardedBatchSampler(n, batch, shard, shards, shuffle=shuffle, seed=5)
    ref = jld.ShardedBatchSampler(n, batch, shard, shards, shuffle=shuffle, seed=5)
    for epoch in (0, 1):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(mine) == list(ref) and len(mine) == len(ref)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"id": i}


@pytest.mark.parametrize("mix_type,accum", [("random", 1), ("random", 2), ("accum", 2)])
def test_meta_loader_order_matches_jax(mix_type, accum):
    """Task choices and batches, across epoch ends, for one seed."""
    def run(L):
        loaders = {}
        for name, n, ratio in (("a", 12, 1), ("b", 20, 3)):
            sampler = L.ShardedBatchSampler(n, 4, shuffle=True, seed=11)
            loaders[name] = (L.DataLoader(_Items(n), sampler, lambda s: [x["id"] for x in s]), ratio)
        it = iter(L.MetaLoader(loaders, accum_steps=accum, seed=9, mix_type=mix_type))
        return [next(it) for _ in range(40)]

    assert run(tld) == run(jld)


def test_threaded_loader_matches_serial_and_closes():
    sampler = tld.ShardedBatchSampler(50, 8, shuffle=True, seed=1)
    collate = lambda s: [x["id"] for x in s]  # noqa: E731
    serial = list(tld.DataLoader(_Items(50), sampler, collate, n_workers=0))
    threaded = tld.DataLoader(_Items(50), sampler, collate, n_workers=3)
    assert list(threaded) == serial
    before = set(threading.enumerate())
    forever = tld.DataLoader(_Items(50), sampler, collate, n_workers=3, repeat=True)
    it = iter(forever)
    assert [next(it) for _ in range(len(serial))] == serial
    closing = threading.Thread(target=forever.close)
    closing.start()
    closing.join(timeout=30)
    assert not closing.is_alive()
    # close() returns with the feeder and its worker pool ended
    assert not [t for t in threading.enumerate() if t not in before]
