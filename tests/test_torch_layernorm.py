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
                                   (300, 1536), (64, 2050), (5, 3000)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_bwd_kernel_matches_plain_on_card(shape, dtypes):
    """dx within one ulp of its type (plus 1e-4 absolute where terms cancel);
    dw and db within 1e-4 relative to the largest |dy| * sqrt(rows): the
    kernel adds the rows in another order than torch's sum."""
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
