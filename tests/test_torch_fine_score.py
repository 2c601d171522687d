"""The fused fine-grained score of the PyTorch port against the JAX package.

``fine_score_fused_plain`` (what the wrapper computes for a CPU tensor) is held
to the JAX ``fine_score_fused`` in interpret mode and to the JAX
``tasks.losses.fine_score``, and ``fine_score_chunked`` to the JAX one, all at
1e-5, the tolerance of tests/test_pallas.py::TestFineScoreFused (fp32 on both
sides, sums in another order).  The CUDA kernel itself is held to the plain
version by the ``cuda``-marked tests, which skip where there is no card.  The
JAX package is imported inside the parity tests only, so that the card's tests
also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fine_score.py

The last tests check that ``ops/kernels/_build.py`` builds two sources side by
side and one source once, with ``nvcc`` stubbed.
"""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from valor_tpu_torch.ops.kernels import _build
from valor_tpu_torch.ops.kernels import fine_score as K2
from valor_tpu_torch.tasks import losses as L

TOL = 1e-5


def _inputs(seed, a=9, b=21, t=7, v=5, d=48, unit=False):
    """tests/test_pallas.py::TestFineScoreFused._inputs as numpy arrays; with
    ``unit`` the token features are L2-normalised, as the eval path's are."""
    rng = np.random.RandomState(seed)
    fa = rng.randn(a, t, d).astype(np.float32)
    fb = rng.randn(b, v, d).astype(np.float32)
    if unit:
        fa /= np.linalg.norm(fa, axis=-1, keepdims=True)
        fb /= np.linalg.norm(fb, axis=-1, keepdims=True)
    ma = (rng.rand(a, t) > 0.3).astype(np.float32)
    ma[:, 0] = 1.0  # every row keeps a valid token
    mb = np.ones((b, v), np.float32)
    wa = rng.randn(a, t).astype(np.float32)
    wb = rng.randn(b, v).astype(np.float32)
    return [fa, fb, ma, mb, wa, wb]


def _case(name):
    """The three cases of TestFineScoreFused, then T = 1 and V = 1."""
    if name == "unaligned":
        return _inputs(0)
    if name == "negative_rows":  # every dot negative: padding may not inject a 0
        fa, fb, ma, mb, wa, wb = _inputs(1, a=4, b=4, t=3, v=2, d=16)
        return [np.abs(fa), -np.abs(fb), np.ones_like(ma), mb, wa, wb]
    if name == "masked_tokens_zero":  # a masked token adds a literal 0, not -inf
        fa, fb, ma, mb, wa, wb = _inputs(2, a=5, b=6, t=4, v=3, d=32)
        ma[:, 1] = 0.0
        return [-np.abs(fa), np.abs(fb), ma, mb, wa, wb]
    if name == "t1":
        return _inputs(3, a=6, b=7, t=1, v=4, d=32)
    fa, fb, ma, mb, wa, wb = _inputs(4, a=6, b=7, t=5, v=1, d=32)
    return [fa, fb, ma, mb, wa, wb]


def _torch(args, feat_dtype=torch.float32, device="cpu"):
    t = [torch.from_numpy(x).to(device) for x in args]
    t[0], t[1] = t[0].to(feat_dtype), t[1].to(feat_dtype)
    return t


CASES = ["unaligned", "negative_rows", "masked_tokens_zero", "t1", "v1"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_pallas_interpret_and_jnp(name):
    import jax.numpy as jnp

    from valor_tpu.ops.pallas.fine_score import fine_score_fused
    from valor_tpu.tasks.losses import fine_score

    args = _case(name)
    jargs = [jnp.asarray(x) for x in args]
    got = K2.fine_score_fused_plain(*_torch(args)).numpy()
    ref = np.asarray(fine_score(*jargs))
    if name == "negative_rows":
        assert float(ref.max()) < 0  # the edge case is live
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    pallas = fine_score_fused(*jargs, block_a=8, block_b=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)


def test_plain_bf16_features_match_jax():
    """bf16 features (fp32 masks and weights): the products of bf16 values are
    exact in fp32, so both sides sum the same terms and 1e-5 holds."""
    import jax.numpy as jnp

    from valor_tpu.ops.pallas.fine_score import fine_score_fused
    from valor_tpu.tasks.losses import fine_score

    args = _inputs(5, a=7, b=10, t=6, v=4, d=64)
    jargs = [jnp.asarray(x) for x in args]
    jargs[0], jargs[1] = jargs[0].astype(jnp.bfloat16), jargs[1].astype(jnp.bfloat16)
    got = K2.fine_score_fused_plain(*_torch(args, torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(fine_score(*jargs)), rtol=TOL, atol=TOL)
    pallas = fine_score_fused(*jargs, block_a=8, block_b=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("a,chunk", [(23, 10), (20, 10), (3, 100)])
def test_chunked_matches_jax(a, chunk):
    import jax.numpy as jnp

    from valor_tpu.tasks.losses import fine_score_chunked

    args = _inputs(6, a=a, b=11, t=5, v=3, d=24)
    ref = fine_score_chunked(*[jnp.asarray(x) for x in args], chunk=chunk)
    got = L.fine_score_chunked(*_torch(args), chunk=chunk)
    assert got.shape == (a, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_gallery_on_cpu_is_chunked_and_launches_nothing():
    args = _torch(_inputs(7, a=13, b=9))
    before = K2.LAUNCHES
    got = L.fine_score_gallery(*args, chunk=4)
    assert K2.LAUNCHES == before
    torch.testing.assert_close(got, L.fine_score_chunked(*args, chunk=4), rtol=0, atol=0)
    # the wrapper on the CPU is the plain version, and counts nothing either
    torch.testing.assert_close(K2.fine_score_fused(*args), K2.fine_score_fused_plain(*args),
                               rtol=0, atol=0)
    assert K2.LAUNCHES == before
    torch.testing.assert_close(got, K2.fine_score_fused_plain(*args), rtol=TOL, atol=TOL)


def test_all_masked_row_is_uniform_not_nan():
    fa, fb, ma, mb, wa, wb = _inputs(8, a=3, b=4)
    ma[1] = 0.0
    got = K2.fine_score_fused_plain(*_torch([fa, fb, ma, mb, wa, wb]))
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, L.fine_score(*_torch([fa, fb, ma, mb, wa, wb])),
                               rtol=TOL, atol=TOL)


def test_empty_sides():
    fa, fb, ma, mb, wa, wb = _torch(_inputs(9, a=4, b=5))
    assert K2.fine_score_fused(fa[:0], fb, ma[:0], mb, wa[:0], wb).shape == (0, 5)
    assert K2.fine_score_fused(fa, fb[:0], ma, mb[:0], wa, wb[:0]).shape == (4, 0)
    assert L.fine_score_chunked(fa[:0], fb, ma[:0], mb, wa[:0], wb).shape == (0, 5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    fa, fb, ma, mb, wa, wb = _torch(_inputs(10, a=3, b=4, t=5, v=2, d=8))
    with pytest.raises(TypeError):  # float16 features
        K2.fine_score_fused(fa.half(), fb.half(), ma, mb, wa, wb)
    with pytest.raises(TypeError):  # mixed feature types
        K2.fine_score_fused(fa, fb.to(torch.bfloat16), ma, mb, wa, wb)
    with pytest.raises(TypeError):  # float64 weights
        K2.fine_score_fused(fa, fb, ma, mb, wa.double(), wb)
    with pytest.raises(TypeError):  # mask of the wrong shape
        K2.fine_score_fused(fa, fb, ma[:, :4].contiguous(), mb, wa, wb)
    with pytest.raises(ValueError):  # D differs
        K2.fine_score_fused(fa, fb[:, :, :4].contiguous(), ma, mb, wa, wb)
    with pytest.raises(ValueError):  # not contiguous
        K2.fine_score_fused(fa.transpose(0, 1).contiguous().transpose(0, 1), fb, ma, mb, wa, wb)
    with pytest.raises(ValueError):  # T beyond 128
        K2.fine_score_fused(torch.zeros(1, 129, 8), fb, torch.ones(1, 129), mb, torch.zeros(1, 129), wb)
    with pytest.raises(ValueError):  # D beyond 4096
        K2.fine_score_fused(torch.zeros(1, 2, 4097), torch.zeros(1, 2, 4097), *(torch.ones(1, 2),) * 4)
    with pytest.raises(ValueError):  # two devices
        K2.fine_score_fused(fa, fb, ma, mb, wa, wb.to("meta"))


# -- the kernel's tiles, from its source on the card ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("t,v,rows,cols", [(32, 10, 128, (250, 120)), (32, 8, 128, (256, 128)),
                                           (8, 34, 128, (238, 102)), (2, 40, 128, (240, 120)),
                                           (32, 1, 128, (256, 128)), (100, 3, 100, (255, 126))])
def test_layout_holds_whole_items(t, v, rows, cols, bf16):
    """MSR-VTT tva, tv, vta, atv and MSCOCO's tiles: whole items on both sides
    of a [128, 256] tile for bf16 and a [128, 128] one for fp32."""
    _cuda()
    lay = K2.layout(1000, 1000, t, v, 512, bf16=bf16)
    assert (lay["rows"], lay["cols"]) == (rows, cols[0] if bf16 else cols[1])
    assert lay["a_tiles"] == -(-1000 // lay["ta"]) and lay["b_tiles"] == -(-1000 // lay["tb"])
    width, value_bytes = (256, 2) if bf16 else (128, 8)
    assert lay["scratch_bytes"] == (lay["a_tiles"] * 128 + lay["b_tiles"] * width) * 512 * value_bytes
    assert lay["read_bytes"] == lay["a_tiles"] * lay["b_tiles"] * (128 + width) * 512 * value_bytes


@pytest.mark.cuda
def test_layout_pads_d_to_a_row():
    _cuda()
    assert K2.layout(3, 4, 5, 6, 13, bf16=True)["d_pad"] == 64
    assert K2.layout(3, 4, 5, 6, 12, bf16=False)["d_pad"] == 32
    assert K2.layout(3, 4, 5, 6, 4096, bf16=False)["d_pad"] == 4096
    assert K2.layout(3, 4, 5, 6, 13, bf16=True)["scratch_bytes"] == (128 + 256) * 64 * 2
    assert K2.layout(3, 4, 5, 6, 12, bf16=False)["scratch_bytes"] == (128 + 128) * 32 * 8


# -- the kernel's fp32 arithmetic, on the CPU ------------------------------------

def test_tf32_split():
    """hi and lo carry no bit below TF32's 10-bit mantissa, hi + lo is x to
    about 2**-22, ties round to even, and inf stays inf with lo 0."""
    x = torch.from_numpy(np.random.RandomState(20).randn(4096).astype(np.float32))
    hi, lo = K2.tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()) < 2.0 ** -21
    ties = torch.tensor([1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, float("inf")])  # halfway cases
    hi, lo = K2.tf32_split(ties)
    assert hi.tolist() == [1.0, 1 + 4 * 2.0 ** -11, float("inf")] and float(lo[2]) == 0.0


@pytest.mark.parametrize("d", [512, 768])
def test_3xtf32_holds_the_tolerance(d):
    """The kernel's fp32 route emulated: hi.hi + hi.lo + lo.hi at MSR-VTT tva's
    token counts, unit-norm features, within 1e-5 + 1e-5 relative of the plain
    version (about 1e-3 of it: the dropped lo.lo is 2**-22 of a term)."""
    args = _torch(_inputs(15, 16, 16, 32, 10, d, unit=True))
    ref = K2.fine_score_fused_plain(*args)
    diff = (K2.fine_score_3xtf32_emulated(*args) - ref).abs()
    assert bool((diff <= TOL + TOL * ref.abs()).all()), float(diff.max())
    assert float(diff.max()) < TOL / 20


def test_single_tf32_misses_the_tolerance():
    """One TF32 product (hi.hi) keeps 11 bits a value: at D = 512 its error is
    of the order of the tolerance itself, and here it exceeds it."""
    args = _torch(_inputs(15, 16, 16, 32, 10, 512, unit=True))
    ref = K2.fine_score_fused_plain(*args)
    diff = (K2.fine_score_3xtf32_emulated(*args, terms=1) - ref).abs()
    assert not bool((diff <= TOL + TOL * ref.abs()).all())


# -- the build of several sources ---------------------------------------------

@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """``_build`` over two stub sources in ``tmp_path``, with ``nvcc`` and the
    loader stubbed: yields the list of built names and lets a test hook in."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    built, hooks = [], {}

    def run(cmd, check):
        out = Path(cmd[cmd.index("-o") + 1])
        name = Path(cmd[-1]).stem
        hooks.get("during", lambda n: None)(name)
        out.write_bytes(b"")
        built.append(name)

    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return built, hooks


def _in_threads(fn, names):
    errors = []

    def target(n):
        try:
            fn(n)
        except BaseException as e:  # noqa: BLE001  (re-raised below, in the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=target, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


def test_two_sources_build_side_by_side(stub_build):
    """Each build waits inside ``nvcc`` until the other has entered it: with
    one lock for every source the second could never enter and the barrier
    would break."""
    built, hooks = stub_build
    barrier = threading.Barrier(2, timeout=10)
    hooks["during"] = lambda name: barrier.wait()
    _in_threads(_build.load_library, ["one", "two"])
    assert sorted(built) == ["one", "two"]


def test_one_source_builds_once(stub_build):
    built, hooks = stub_build
    entered = threading.Event()
    hooks["during"] = lambda name: (entered.set(), threading.Event().wait(0.2))
    _in_threads(_build.load_library, ["one"] * 4)
    assert entered.is_set() and built == ["one"]
    assert _build.load_library("one") == _build.load_library("one")


# -- on the card ------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _close_on_card(got, ref):
    """1e-5 absolute plus 1e-5 relative on unit-norm features (|dot| <= 1):
    bf16 products are exact in fp32 and fp32 ones 3xTF32 (about 2**-22 a
    term, ``test_3xtf32_holds_the_tolerance``), summed in another order than
    the plain version's matmul."""
    diff = (got - ref).abs()
    assert bool((diff <= TOL + TOL * ref.abs()).all()), float(diff.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 21, 7, 5, 48), (33, 70, 32, 10, 512), (40, 30, 2, 40, 512),
                                   (5, 3, 128, 128, 1024), (70, 300, 32, 1, 512), (6, 7, 1, 1, 5),
                                   (4, 9, 3, 6, 13),
                                   # gallery items straddling the 256-column tile (25 a tile)
                                   (9, 26, 32, 10, 512),
                                   (6, 40, 64, 10, 512),  # T = 64: two query items a tile
                                   (5, 30, 32, 10, 4096),
                                   (7, 11, 32, 10, 12), (7, 11, 32, 10, 13),  # D padded by the pack
                                   (1, 30, 32, 10, 512), (20, 1, 32, 10, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(shape, dtype):
    dev = _cuda()
    a, b, t, v, d = shape
    args = _torch(_inputs(11, a, b, t, v, d, unit=True), dtype, dev)
    before = K2.LAUNCHES
    got = K2.fine_score_fused(*args)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == before + 1 and got.shape == (a, b) and got.dtype == torch.float32
    _close_on_card(got, K2.fine_score_fused_plain(*args))
    assert torch.equal(got, K2.fine_score_fused(*args))  # no atomics: the same bits again


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 4096])
def test_kernel_same_sign_long_dots_on_card(d, dtype):
    """Every term of every dot of one sign (negative_rows at D up to 4096): no
    cancellation hides the rounding of the tensor cores' accumulators."""
    dev = _cuda()
    fa, fb, ma, mb, wa, wb = _inputs(13, 6, 9, 3, 2, d, unit=True)
    args = _torch([np.abs(fa), -np.abs(fb), np.ones_like(ma), mb, wa, wb], dtype, dev)
    got = K2.fine_score_fused(*args)
    ref = K2.fine_score_fused_plain(*args)
    assert float(ref.max()) < 0
    _close_on_card(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_edge_cases_on_card(name):
    dev = _cuda()
    args = _torch(_case(name), device=dev)
    got = K2.fine_score_fused(*args)
    ref = K2.fine_score_fused_plain(*args)
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
    if name == "negative_rows":
        assert float(got.max()) < 0


@pytest.mark.cuda
def test_gallery_on_card_launches_the_kernel():
    dev = _cuda()
    args = _torch(_inputs(12, a=23, b=17, unit=True), device=dev)
    before = K2.LAUNCHES
    got = L.fine_score_gallery(*args)
    assert K2.LAUNCHES == before + 1
    torch.testing.assert_close(got, L.fine_score_chunked(*args, chunk=10), rtol=TOL, atol=TOL)
    empty = K2.fine_score_fused(args[0][:0], *args[1:2], args[2][:0], args[3], args[4][:0], args[5])
    assert empty.shape == (0, 17) and K2.LAUNCHES == before + 1
