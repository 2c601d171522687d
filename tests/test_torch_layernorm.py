"""LayerNorm forward and backward of the PyTorch port against the JAX package.

``layernorm_plain`` and ``layernorm_bwd_plain`` (what the wrappers compute for
a CPU tensor) are held to the Pallas kernel in interpret mode and to
``valor_tpu.ops.layers.LayerNorm``: forward at 2e-5 and gradients at 1e-4, the
tolerances of tests/test_pallas.py::TestFusedLayerNorm.  The CUDA kernels
themselves are held to the plain versions by the ``cuda``-marked tests, which
skip where there is no card.  The JAX package is imported inside the parity
tests only, so that the card's tests also run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_layernorm.py
"""

import numpy as np
import pytest
import torch

from valor_tpu_torch.ops import layers as tl
from valor_tpu_torch.ops.kernels import layernorm as K

TOL = 2e-5

CASES = [
    ((6, 10, 128), 1e-12),
    ((6, 10, 128), 1e-5),
    ((37, 768), 1e-12),  # ragged rows at the main-path width
    ((2, 19, 768), 1e-5),
]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + 0.5).astype(np.float32)
    w = (rng.rand(c) + 0.5).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    return x, w, b


def _plain(x, w, b, eps):
    return K.layernorm_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), eps, torch.float32
    ).numpy()


@pytest.mark.parametrize("shape,eps", CASES)
def test_plain_matches_pallas_interpret(shape, eps):
    import jax.numpy as jnp

    from valor_tpu.ops.pallas.layernorm import fused_layernorm

    x, w, b = _inputs(shape, 0)
    ref = fused_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps, 8, True)
    np.testing.assert_allclose(_plain(x, w, b, eps), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,eps", CASES)
def test_module_matches_flax_layernorm(shape, eps):
    import jax.numpy as jnp

    from valor_tpu.ops.layers import LayerNorm as JaxLayerNorm

    x, w, b = _inputs(shape, 1)
    jln = JaxLayerNorm(eps=eps)
    ref = jln.apply({"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    mod = tl.LayerNorm(shape[-1], eps, torch.float32, "cpu")
    mod.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)})
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=TOL, atol=TOL)


def test_cpu_wrapper_is_plain_and_casts():
    x, w, b = _inputs((5, 64), 2)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    before = K.LAUNCHES
    y = K.layernorm(xt, wt, bt, 1e-5, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and K.LAUNCHES == before  # no kernel on the CPU
    torch.testing.assert_close(y, K.layernorm_plain(xt, wt, bt, 1e-5, torch.bfloat16), rtol=0, atol=0)
    y16 = K.layernorm(xt.to(torch.bfloat16), wt, bt, 1e-5, torch.float32)
    assert y16.dtype == torch.float32 and y16.shape == (5, 64)


GRAD_TOL = 1e-4


def _jax_grads(x, w, b, eps):
    """Grads of sum(sin(LN(x))) through the Pallas kernel in interpret mode."""
    import jax
    import jax.numpy as jnp

    from valor_tpu.ops.pallas.layernorm import fused_layernorm

    f = lambda x, w, b: jnp.sum(jnp.sin(fused_layernorm(x, w, b, eps, 8, True)))  # noqa: E731
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))]


def _torch_grads(x, w, b, eps):
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    torch.sin(K.layernorm(xt, wt, bt, eps, torch.float32)).sum().backward()
    return [t.grad.numpy() for t in (xt, wt, bt)]


def test_forward_parity():
    """TestFusedLayerNorm.test_forward_parity, through the autograd Function."""
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(*s).astype(np.float32) for s in ((6, 10, 128), (128,), (128,)))
    import jax.numpy as jnp

    from valor_tpu.ops.pallas.layernorm import fused_layernorm

    ref = fused_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-12, 8, True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = K.layernorm(xt, torch.from_numpy(w), torch.from_numpy(b), 1e-12, torch.float32)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,eps", [((4, 128), 1e-12), ((3, 7, 768), 1e-5), ((37, 500), 1e-12)])
def test_grad_parity(shape, eps):
    """TestFusedLayerNorm.test_grad_parity: dx, dw and db of sum(sin(LN(x)))
    against jax.grad through the Pallas kernel, within 1e-4 as that test states."""
    rng = np.random.RandomState(1)
    c = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.rand(c) + 0.5).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    if c % 128:  # the Pallas kernel takes C % 128 == 0 only: compare with plain JAX autodiff
        import jax
        import jax.numpy as jnp

        def f(x, w, b):
            xf = x.astype(jnp.float32)
            mean = xf.mean(-1, keepdims=True)
            var = ((xf - mean) ** 2).mean(-1, keepdims=True)
            return jnp.sum(jnp.sin((xf - mean) * jax.lax.rsqrt(var + eps) * w + b))

        ref = [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(x, w, b)]
    else:
        ref = _jax_grads(x, w, b, eps)
    for got, want in zip(_torch_grads(x, w, b, eps), ref):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_row_padding():
    """TestFusedLayerNorm.test_row_padding: 5 rows, not a multiple of the
    Pallas kernel's 8-row block, forward and grads."""
    rng = np.random.RandomState(2)
    x = rng.randn(5, 128).astype(np.float32)
    w, b = np.ones(128, np.float32), np.zeros(128, np.float32)
    import jax.numpy as jnp

    from valor_tpu.ops.pallas.layernorm import fused_layernorm

    ref = fused_layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-12, 8, True)
    np.testing.assert_allclose(_plain(x, w, b, 1e-12), np.asarray(ref), rtol=TOL, atol=TOL)
    for got, want in zip(_torch_grads(x, w, b, 1e-12), _jax_grads(x, w, b, 1e-12)):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_function_saves_x_and_w_and_keeps_dtypes():
    x, w, b = _inputs((6, 64), 4)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = K.layernorm(xt, wt, bt, 1e-5, torch.float32)
    assert type(y.grad_fn).__name__ == "LayerNormFunctionBackward"
    saved = y.grad_fn.saved_tensors  # x and w; no statistics
    assert [t.data_ptr() for t in saved] == [xt.data_ptr(), wt.data_ptr()]
    dy = torch.randn(64, 6).t()  # not contiguous: the Function makes it so
    assert not dy.is_contiguous()
    before = K.LAUNCHES_BWD
    y.backward(dy)
    assert K.LAUNCHES_BWD == before  # the plain version on the CPU
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    dx, dw, db = K.layernorm_bwd_plain(xt.detach(), wt.detach(), 1e-5, dy.contiguous())
    torch.testing.assert_close(xt.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(wt.grad, dw, rtol=0, atol=0)
    torch.testing.assert_close(bt.grad, db, rtol=0, atol=0)
    # without grad the wrapper records nothing
    with torch.no_grad():
        assert K.layernorm(xt, wt, bt, 1e-5, torch.float32).grad_fn is None


def test_bwd_wrapper_checks():
    x = torch.randn(4, 64)
    w = torch.ones(64)
    with pytest.raises(TypeError):
        K.layernorm_bwd(x, w, 1e-5, torch.randn(4, 32))
    with pytest.raises(ValueError):
        K.layernorm_bwd(x, w, 1e-5, torch.randn(64, 4).t())
    dx, dw, db = K.layernorm_bwd(x, w, 1e-5, torch.randn(4, 64, dtype=torch.bfloat16))
    assert dx.dtype == torch.float32 and dw.shape == db.shape == (64,)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.randn(4, 64)
    w, b = torch.ones(64), torch.zeros(64)
    with pytest.raises(TypeError):
        K.layernorm(x.half(), w, b, 1e-5, torch.float32)
    with pytest.raises(TypeError):
        K.layernorm(x, w.double(), b, 1e-5, torch.float32)
    with pytest.raises(TypeError):
        K.layernorm(x, w[:32], b, 1e-5, torch.float32)
    with pytest.raises(ValueError):
        K.layernorm(torch.randn(64, 4).t(), w, b, 1e-5, torch.float32)  # not contiguous
    with pytest.raises(ValueError):
        K.layernorm(torch.randn(2, 4097), torch.ones(4097), torch.zeros(4097), 1e-5, torch.float32)


# -- what the cheaper checks still reject ----------------------------------

def _bad_fwd(case, c):
    """(x, w, b, out_dtype) with one thing wrong, named by ``case``."""
    x, w, b = torch.randn(4, c), torch.ones(c), torch.zeros(c)
    meta = torch.device("meta")
    bad = {
        "x_float16": lambda: (x.half(), w, b, torch.float32),
        "x_float64": lambda: (x.double(), w, b, torch.float32),
        "out_float16": lambda: (x, w, b, torch.float16),
        "w_bfloat16": lambda: (x, w.bfloat16(), b, torch.float32),
        "b_float64": lambda: (x, w, b.double(), torch.float32),
        "w_short": lambda: (x, w[:-1].contiguous(), b, torch.float32),
        "b_2d": lambda: (x, w, b[None], torch.float32),
        "x_no_cols": lambda: (torch.randn(4, 0), w, b, torch.float32),
        "x_scalar": lambda: (torch.tensor(1.0), w, b, torch.float32),
        "x_too_wide": lambda: (torch.randn(2, 4097), torch.ones(4097), torch.zeros(4097), torch.float32),
        "w_on_meta": lambda: (x, w.to(meta), b, torch.float32),
        "b_on_meta": lambda: (x, w, b.to(meta), torch.float32),
        "all_on_meta": lambda: (x.to(meta), w.to(meta), b.to(meta), torch.float32),
        "x_strided": lambda: (torch.randn(c, 4).t(), w, b, torch.float32),
        "w_strided": lambda: (x, torch.ones(2 * c)[::2], b, torch.float32),
        "b_strided": lambda: (x, w, torch.zeros(2 * c)[::2], torch.float32),
    }
    return bad[case]()


FWD_REJECTS = [
    ("x_float16", TypeError), ("x_float64", TypeError), ("out_float16", TypeError),
    ("w_bfloat16", TypeError), ("b_float64", TypeError), ("w_short", TypeError),
    ("b_2d", TypeError), ("x_no_cols", ValueError), ("x_scalar", ValueError),
    ("x_too_wide", ValueError), ("w_on_meta", ValueError), ("b_on_meta", ValueError),
    ("all_on_meta", ValueError), ("x_strided", ValueError), ("w_strided", ValueError),
    ("b_strided", ValueError),
]


@pytest.mark.parametrize("case,error", FWD_REJECTS)
def test_forward_rejects_after_a_good_call(case, error):
    """Every rejection of the checks, right after a good call of the same
    width: nothing from the good call lets a bad tensor through."""
    c = 64
    x, w, b = torch.randn(4, c), torch.ones(c), torch.zeros(c)
    K.layernorm(x, w, b, 1e-5, torch.float32)
    bx, bw, bb, out_dtype = _bad_fwd(case, c)
    with pytest.raises(error):
        K.layernorm(bx, bw, bb, 1e-5, out_dtype)


BWD_REJECTS = [
    ("dy_float16", TypeError), ("dy_float64", TypeError), ("dy_shape", TypeError),
    ("dy_on_meta", TypeError), ("dy_strided", ValueError), ("x_float16", TypeError),
    ("w_bfloat16", TypeError), ("w_short", TypeError), ("x_strided", ValueError),
    ("w_strided", ValueError), ("x_too_wide", ValueError),
]


@pytest.mark.parametrize("case,error", BWD_REJECTS)
def test_backward_rejects_after_a_good_call(case, error):
    c = 64
    x, w, dy = torch.randn(4, c), torch.ones(c), torch.randn(4, c)
    K.layernorm_bwd(x, w, 1e-5, dy)
    if case.startswith("dy_"):
        bad_dy = {
            "dy_float16": dy.half(), "dy_float64": dy.double(), "dy_shape": dy[:, :32],
            "dy_on_meta": dy.to("meta"), "dy_strided": torch.randn(c, 4).t(),
        }[case]
        args = (x, w, 1e-5, bad_dy)
    else:
        bx, bw, _, _ = _bad_fwd(case, c)
        args = (bx, bw, 1e-5, torch.randn(bx.shape))
    with pytest.raises(error):
        K.layernorm_bwd(*args)


# -- the backward's grid ---------------------------------------------------

# row groups a block of the backward kernel has at a width, with its pointers
# 16-byte aligned or not: on a vector path (aligned, C % 4 == 0) a group is 1
# warp up to C = 768, 2 up to 1536, 4 up to 3072, 8 up to 4096; on the scalar
# path 1 warp up to 512, 2 up to 1024, 4 up to 2048, 8 up to 4096; 8 warps a block
GROUPS = {(1, True): 8, (500, True): 8, (500, False): 8, (512, True): 8, (512, False): 8,
          (768, True): 8, (768, False): 4, (1536, True): 4, (3072, True): 2, (4096, True): 1,
          (4096, False): 1}


@pytest.mark.parametrize("cols", [1, 500, 512, 768, 4096])
@pytest.mark.parametrize("n_rows", [1, 3, 5, 1000, 1280, 4128, 25216])
def test_bwd_grid_covers_every_row_once(n_rows, cols):
    """``bwd_grid``'s (blocks, steps), walked as the kernel walks them (block
    b, step s, group g take row b*G*steps + s*G + g), cover every row exactly
    once, leave no block empty and stay within the wave, for waves of one to
    three blocks an SM of an H100 and for a small one."""
    for (c, _), groups in GROUPS.items():
        if c == cols:
            _check_grid(n_rows, groups)


def _check_grid(n_rows, groups):
    for wave in (132, 264, 396, 7):
        blocks, steps = K.bwd_grid(n_rows, groups, wave)
        assert 1 <= blocks <= wave and steps >= 1
        b, s, g = np.meshgrid(np.arange(blocks), np.arange(steps), np.arange(groups), indexing="ij")
        rows = (b * groups * steps + s * groups + g).reshape(-1)
        np.testing.assert_array_equal(np.sort(rows[rows < n_rows]), np.arange(n_rows))
        assert (blocks - 1) * groups * steps < n_rows  # the last block has a row
        # no smaller step count keeps the grid within the wave
        assert steps == 1 or -(-n_rows // (groups * (steps - 1))) > wave


@pytest.mark.parametrize("n_rows", [1, 3, 64, 1000, 1280, 4128, 25216])
def test_bwd_grid_for_sizes_one_buffer(n_rows, monkeypatch):
    """The memoised grid of a call, with the library's occupancy stubbed (264
    blocks, an H100's wave at two blocks an SM): ``bwd_grid``'s blocks and
    steps, and one fp32 buffer of dw, db and a [2, C] partial a block, the
    library asked once a key."""
    asked = []

    def fake_info(dev, cols, x_bf16, dy_bf16, aligned):
        asked.append(cols)
        return 8, 264, 1

    monkeypatch.setattr(K, "bwd_info", fake_info)
    monkeypatch.setattr(K, "_BWD_GRID", {})
    blocks, steps, floats = K._bwd_grid_for(0, n_rows, 768, True, True, True)
    assert (blocks, steps) == K.bwd_grid(n_rows, 8, 264)
    assert floats == (1 + blocks) * 2 * 768
    assert K._bwd_grid_for(0, n_rows, 768, True, True, True) == (blocks, steps, floats)
    assert asked == [768]


# -- on the card ------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16 * 32, 768), (1000, 500), (33, 4096), (7, 1), (3, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(shape, dtype):
    dev = _cuda()
    x, w, b = _inputs(shape, 3)
    xt = torch.from_numpy(x).to(dev, dtype)
    wt, bt = torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)
    before = K.LAUNCHES
    y = K.layernorm(xt, wt, bt, 1e-5, dtype)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    ref = K.layernorm_plain(xt, wt, bt, 1e-5, dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=0, atol=1e-5)
    else:  # one bf16 ulp (2**-7 relative), plus 1e-5 where w*xhat and b cancel
        diff = (y.float() - ref.float()).abs()
        scale = torch.maximum(y.float().abs(), ref.float().abs())
        assert bool((diff <= scale * 2.0**-7 + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1280, 768), (1000, 500), (33, 4096), (7, 1), (3, 100),
                                   (300, 1536), (64, 2050), (5, 3000), (4128, 768), (4128, 500)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_bwd_kernel_matches_plain_on_card(shape, dtypes):
    """dx within one ulp of its type (plus 1e-4 absolute where terms cancel);
    dw and db within 1e-4 relative to the largest |dy| * sqrt(rows): the
    kernel adds the rows in another order than torch's sum.  The 4128-row
    shapes give a row group two rows, staged through shared memory on every
    vector width and copy size."""
    dev = _cuda()
    xd, gd = dtypes
    x, w, _ = _inputs(shape, 5)
    xt = torch.from_numpy(x).to(dev, xd)
    wt = torch.from_numpy(w).to(dev)
    dy = torch.randn(shape, generator=torch.Generator().manual_seed(6)).to(dev, gd)
    before = K.LAUNCHES_BWD
    dx, dw, db = K.layernorm_bwd(xt, wt, 1e-5, dy)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BWD == before + 1
    rx, rw, rb = K.layernorm_bwd_plain(xt, wt, 1e-5, dy)
    ulp = 2.0 ** -7 if xd == torch.bfloat16 else 2.0 ** -20
    diff = (dx.float() - rx.float()).abs()
    assert bool((diff <= ulp * rx.float().abs() + 1e-4).all()), float(diff.max())
    scale = float(dy.float().abs().max()) * shape[0] ** 0.5
    torch.testing.assert_close(dw, rw, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(db, rb, rtol=1e-4, atol=1e-4 * scale)
    # no atomics: the same inputs give the same bits
    dx2, dw2, db2 = K.layernorm_bwd(xt, wt, 1e-5, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
def test_kernel_backward_through_autograd_on_card():
    dev = _cuda()
    x, w, b = _inputs((2, 19, 768), 7)
    grads = {}
    for d in ("cpu", dev):
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        wt = torch.from_numpy(w).to(d).requires_grad_(True)
        bt = torch.from_numpy(b).to(d).requires_grad_(True)
        fwd, bwd = K.LAUNCHES, K.LAUNCHES_BWD
        torch.sin(K.layernorm(xt, wt, bt, 1e-12, torch.float32)).sum().backward()
        if d != "cpu":
            assert (K.LAUNCHES, K.LAUNCHES_BWD) == (fwd + 1, bwd + 1)
        grads[str(d)] = [t.grad.cpu() for t in (xt, wt, bt)]
    for got, want in zip(grads[str(dev)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_bwd_info_matches_the_grid_rule():
    """The kernel's row groups a block are those the grid test assumes, its wave
    fills every SM, and the backward is one launch at every width."""
    _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (cols, aligned), groups in GROUPS.items():
        got_groups, wave, launches = K.bwd_info(0, cols, 1, 1, aligned)
        assert (got_groups, launches) == (groups, 1) and wave >= sms


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 3, 1280, 4128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_rows_at_main_width(n_rows, dtype):
    """One row, a few, and the fusion and AST row counts at C = 768: the kernel
    against its plain version (``test_bwd_kernel_matches_plain_on_card``'s
    tolerances), one launch a call, and dw and db the same bits on a second
    call."""
    dev = _cuda()
    x, w, _ = _inputs((n_rows, 768), 8)
    xt, wt = torch.from_numpy(x).to(dev, dtype), torch.from_numpy(w).to(dev)
    dy = torch.randn((n_rows, 768), generator=torch.Generator().manual_seed(9)).to(dev, dtype)
    before = K.LAUNCHES_BWD
    dx, dw, db = K.layernorm_bwd(xt, wt, 1e-12, dy)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BWD == before + 1
    rx, rw, rb = K.layernorm_bwd_plain(xt, wt, 1e-12, dy)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    diff = (dx.float() - rx.float()).abs()
    assert bool((diff <= ulp * rx.float().abs() + 1e-4).all()), float(diff.max())
    scale = float(dy.float().abs().max()) * n_rows ** 0.5
    torch.testing.assert_close(dw, rw, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(db, rb, rtol=1e-4, atol=1e-4 * scale)
    _, dw2, db2 = K.layernorm_bwd(xt, wt, 1e-12, dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1280, 768), (25216, 768), (1000, 500), (2048, 4096)])
def test_bwd_graph_replay_equals_eager(shape):
    """The cooperative launch captures into a CUDA graph; a replay on new
    inputs copied into the captured buffers gives the eager call's bits."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(shape, device=dev, generator=gen).bfloat16()
    w = torch.rand(shape[1], device=dev, generator=gen) + 0.5
    dy = torch.randn(shape, device=dev, generator=gen).bfloat16()
    K.layernorm_bwd(x, w, 1e-5, dy)  # the first call of a width asks the occupancy, uncaptured
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.layernorm_bwd(x, w, 1e-5, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.layernorm_bwd(x, w, 1e-5, dy)
    x.copy_(torch.randn(shape, device=dev, generator=gen))
    dy.copy_(torch.randn(shape, device=dev, generator=gen))
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(out, K.layernorm_bwd(x, w, 1e-5, dy)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 768), (1280, 512), (1280, 768)])
def test_fwd_graph_replay_equals_eager(shape):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(shape, device=dev, generator=gen).bfloat16()
    w = torch.rand(shape[1], device=dev, generator=gen) + 0.5
    b = torch.randn(shape[1], device=dev, generator=gen)
    K.layernorm(x, w, b, 1e-12, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.layernorm(x, w, b, 1e-12, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.layernorm(x, w, b, 1e-12, torch.bfloat16)
    x.copy_(torch.randn(shape, device=dev, generator=gen))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, K.layernorm(x, w, b, 1e-12, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1280, 768), (1000, 500), (64, 4096)])
def test_bwd_unaligned_pointers_on_card(shape):
    """x, dy and w one element past a 16-byte boundary: the kernel takes its
    scalar path (wider row groups at C = 768) and still matches its plain
    version, one launch a call, with the same bits twice."""
    dev = _cuda()
    n, c = shape
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n * c + 1, device=dev, generator=gen)[1:].view(n, c)
    dy = torch.randn(n * c + 1, device=dev, generator=gen)[1:].view(n, c)
    w = (torch.rand(c + 1, device=dev, generator=gen) + 0.5)[1:]
    assert x.data_ptr() % 16 and K.bwd_plan(x, w, dy, torch.empty_like(x))["launches"] == 1
    before = K.LAUNCHES_BWD
    dx, dw, db = K.layernorm_bwd(x, w, 1e-5, dy)
    torch.cuda.synchronize()
    assert K.LAUNCHES_BWD == before + 1
    rx, rw, rb = K.layernorm_bwd_plain(x, w, 1e-5, dy)
    diff = (dx - rx).abs()
    assert bool((diff <= 2.0 ** -20 * rx.abs() + 1e-4).all()), float(diff.max())
    scale = float(dy.abs().max()) * n ** 0.5
    torch.testing.assert_close(dw, rw, rtol=1e-4, atol=1e-4 * scale)
    torch.testing.assert_close(db, rb, rtol=1e-4, atol=1e-4 * scale)
    _, dw2, db2 = K.layernorm_bwd(x, w, 1e-5, dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
