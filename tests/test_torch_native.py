"""The port's build of the C++ data-path runtime (``valor_tpu_torch/data/native.py``)
against the JAX package's (``valor_tpu/data/native.py``, the tracked
``native/libvalor_native.so``) on the same files (CPU).

Both are ``native/valor_native.cpp`` compiled with ``native/Makefile``'s flags;
the port's copy is built with ``g++`` at first use.  Tolerances: uint8 frames
bit for bit (the two builds round alike); float frames within 1e-6 and the
fbank within 1e-5, absolute (the same arithmetic; the bound leaves room for a
compiler that contracts differently).  ``VideoMapper`` with
``transforms="none"`` takes the decoder in both packages and must agree
exactly.  Every test here needs both libraries; where the port's copy does
not build, the build test fails with the compiler's message.
"""

import math

import numpy as np
import pytest
from PIL import Image

from valor_tpu.data import native as jnat
from valor_tpu.data import pipeline as jpl
from valor_tpu_torch.data import native as tnat
from valor_tpu_torch.data import pipeline as tpl

MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Noisy and smooth JPEGs of several sizes, up- and downscaled to 32 and 224."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(240, 320), (48, 64), (100, 77), (20, 30), (360, 480), (64, 64)]):
        arr = rng.randint(0, 256, (h, w, 3), np.uint8)
        if i % 2:
            arr = np.clip(np.cumsum(rng.randn(h, w, 3), axis=1) * 8 + 128, 0, 255).astype(np.uint8)
        p = root / f"img_{i:04d}.jpg"
        Image.fromarray(arr).save(p, quality=90)
        paths.append(str(p))
    return paths


def test_the_copy_builds_and_loads():
    assert jnat.available(), "the JAX package's tracked library does not load"
    assert tnat.available(), tnat.BUILD_ERROR
    assert tnat.BUILD_ERROR is None


@pytest.mark.parametrize("size", [(32, 32), (224, 224), (24, 40)])
def test_decode_resize_batch_u8_matches_jax_bit_for_bit(jpegs, size):
    calls = tnat.CALLS
    got, failed = tnat.decode_resize_batch_u8(jpegs, size)
    want, jfailed = jnat.decode_resize_batch_u8(jpegs, size)
    assert failed == jfailed == 0 and got.dtype == np.uint8 and got.shape == (len(jpegs), *size, 3)
    np.testing.assert_array_equal(got, want)
    assert tnat.CALLS == calls + 1


@pytest.mark.parametrize("size", [(32, 32), (224, 224)])
def test_decode_resize_batch_matches_jax(jpegs, size):
    got, failed = tnat.decode_resize_batch(jpegs, size, MEAN, STD)
    want, _ = jnat.decode_resize_batch(jpegs, size, MEAN, STD)
    assert failed == 0 and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seconds,rate,bins", [(1.0, 22050, 64), (2.5, 16000, 128), (0.03, 22050, 64)])
def test_fbank_matches_jax(seconds, rate, bins):
    rng = np.random.RandomState(1)
    t = np.arange(int(seconds * rate), dtype=np.float32) / rate
    wav = (np.sin(2 * math.pi * 440 * t) * 0.5 + rng.randn(len(t)) * 0.05).astype(np.float32)
    got, want = tnat.fbank(wav, rate, bins), jnat.fbank(wav, rate, bins)
    assert got.shape == want.shape and got.shape[1] == bins
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fbank_shorter_than_a_frame_raises_in_both():
    wav = np.zeros(100, np.float32)
    for mod in (tnat, jnat):
        with pytest.raises(ValueError, match="shorter than one frame"):
            mod.fbank(wav, 22050)


def test_a_corrupt_file_counts_as_a_failure_in_both(jpegs, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    paths = [jpegs[0], str(bad), str(tmp_path / "missing.jpg")]
    for u8 in (True, False):
        outs = []
        for mod in (tnat, jnat):
            out, failed = (mod.decode_resize_batch_u8(paths, (16, 16)) if u8
                           else mod.decode_resize_batch(paths, (16, 16), MEAN, STD))
            assert failed == 2 and np.all(out[1:] == 0)
            outs.append(out)
        np.testing.assert_array_equal(*outs)


def test_the_copy_agrees_with_pil_as_the_jax_decoder_does(jpegs):
    """tests/test_native.py's bar: correlation above 0.98 with PIL's resize."""
    got, _ = tnat.decode_resize_batch(jpegs[:1], (32, 32), MEAN, STD)
    ref = (np.asarray(Image.open(jpegs[0]).convert("RGB").resize((32, 32), Image.BILINEAR), np.float32)
           / 255.0 - MEAN) / STD
    assert np.corrcoef(got[0].ravel(), ref.ravel())[0, 1] > 0.98


@pytest.fixture
def frame_dirs(tmp_path, jpegs):
    for vid in ("vid0", "vid1"):
        d = tmp_path / vid
        d.mkdir()
        for i, p in enumerate(jpegs[:5] if vid == "vid0" else jpegs[1:]):
            (d / f"img_{i:04d}.jpg").write_bytes(open(p, "rb").read())
    (tmp_path / "vid2").mkdir()
    (tmp_path / "vid2" / "img_0000.jpg").write_bytes(b"broken")
    return tmp_path


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("training", [False, True])
def test_video_mapper_none_matches_jax_native_branch(frame_dirs, uint8, training, monkeypatch):
    """``transforms="none"`` video frames decode through each package's build
    (the random chunk picks seeded alike in training); a broken frame is None in both."""
    import random

    orig = random.Random
    monkeypatch.setattr(random, "Random", lambda *a: orig(0))
    kw = dict(resolution=32, sample_num=3, transforms="none", training=training, output_uint8=uint8)
    mine, ref = tpl.VideoMapper(str(frame_dirs), **kw), jpl.VideoMapper(str(frame_dirs), **kw)
    calls = tnat.CALLS
    for vid in ("vid0", "vid1"):
        got, want = mine[vid], ref[vid]
        assert got.shape == (3, 32, 32, 3) and got.dtype == (np.uint8 if uint8 else np.float32)
        np.testing.assert_array_equal(got, want)
    assert tnat.CALLS == calls + 2  # the port decoded with its build, not with PIL
    assert mine["vid2"] is None and ref["vid2"] is None


def test_crop_flip_and_images_still_decode_with_pil(frame_dirs):
    calls = tnat.CALLS
    tpl.VideoMapper(str(frame_dirs), resolution=32, sample_num=2, transforms="crop_flip")["vid0"]
    tpl.VideoMapper(str(frame_dirs / "vid0"), resolution=32, datatype="image")["img_0000.jpg"]
    assert tnat.CALLS == calls


def test_a_failed_build_logs_once_and_falls_back_to_pil(frame_dirs, monkeypatch, caplog):
    """Where the copy does not build, ``available()`` is False, the compiler's
    message is kept and logged once at WARNING, and frames decode with PIL."""
    import logging

    from valor_tpu_torch.ops.kernels import _build

    def broken(name, host=False):
        raise _build.BuildError("building valor_native.cpp: g++ exited 1:\nfatal error: jpeglib.h: No such file")

    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "_tried", False)
    monkeypatch.setattr(tnat, "BUILD_ERROR", None)
    monkeypatch.setattr(_build, "load_library", broken)
    with caplog.at_level(logging.WARNING):
        assert not tnat.available() and not tnat.available()
    assert "jpeglib.h" in tnat.BUILD_ERROR
    assert sum("native decoder did not build" in r.getMessage() for r in caplog.records) == 1
    calls = tnat.CALLS
    out = tpl.VideoMapper(str(frame_dirs), resolution=32, sample_num=3, transforms="none",
                          training=False, output_uint8=True)["vid0"]
    monkeypatch.setattr(jnat, "available", lambda: False)
    ref = jpl.VideoMapper(str(frame_dirs), resolution=32, sample_num=3, transforms="none",
                          training=False, output_uint8=True)["vid0"]
    np.testing.assert_array_equal(out, ref)
    assert tnat.CALLS == calls


def test_host_build_failure_names_its_cause(tmp_path, monkeypatch):
    """``load_library(host=True)`` keeps the compiler's output in its error."""
    from valor_tpu_torch.ops.kernels import _build

    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(_build.BuildError, match="broken.cpp") as err:
        _build.load_library("broken", host=True)
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))
