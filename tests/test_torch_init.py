"""The port's untrained weights against the JAX package's ``model.init`` (CPU).

``models/bridge.py:init_params(law="jax")`` must draw every parameter from the
law that ``valor_tpu``'s initializer draws it from, for the dense, MoE,
grouped-query and VideoSwin tiny configs; ``cli/build.py`` must start
``cli.train`` from it.  The two packages cannot draw the same bits
(``jax.random`` against ``torch.Generator``), so the test holds statistics:

  * ones, zeros and the temperatures exactly (constants: to float32's rounding);
  * for every other key of n values, each package's mean within 5 sigma/sqrt(n)
    of 0 and its std within 5/sqrt(2n) of the law's sigma (five standard
    errors of a sample's mean and std), and the two packages' stds within
    5/sqrt(n) of each other (the ratio of two such samples);
  * keys of under 64 values pooled by law, so that no sample is too small;
  * a truncated law's values inside its bounds in both packages, and reaching
    near them (above 0.9 of the bound); a normal law's largest value past 2.2
    sigma wherever a key holds 2000 values or more (a truncated draw cannot).

The laws (``LAW``) are read from the JAX package's sources: ``ops/layers.py``
(Dense, ``_KVDense``, attention and ``Embed`` at N(0, 0.02)), ``ops/moe.py``,
``models/clip.py``, ``models/ast.py``, ``models/bert.py``, ``models/valor.py``
and ``models/videoswin.py``; flax's ``lecun_normal`` for the patch-embed convs is
``variance_scaling(1, "fan_in", "truncated_normal")``, a normal cut at +-2 sigma
whose sigma is divided by 0.87962566 so that the draw's std is 1/sqrt(fan_in);
``truncated_normal(0.02)`` cuts at +-0.04 and does not correct, so its std is
about 0.0176.
"""

import math

import numpy as np
import pytest
import torch

from valor_tpu_torch.models.bridge import init_params

CASES = {
    "dense": dict(),
    "moe": dict(fusion_moe_experts=4, fusion_moe_every=2),
    "gqa": dict(fusion_cross_attn_kv_heads=1),
    "videoswin": dict(video_encoder_type="videoswin_tiny_test", txt_encoder_type="bert_base_uncased",
                      init_clip_head=False),
}
SMALL = 64  # keys with fewer values are pooled by law
TRUNC_STD = 0.87962566103423978  # std of N(0, 1) cut at +-2
NORMAL_TAIL = 2000  # a normal key this large must reach past 2.2 sigma


def LAW(name: str, shape, vision_width: int):
    """(kind, sigma, bound) of a parameter, by its port name: kind "ones",
    "zeros", "const", "normal" or "trunc" (sigma the drawn std; bound the cut)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("logit_scale", "contra_temp"):
        return "const", None, None
    if leaf in ("bias", "decoder_bias", "b1", "b2"):
        return "zeros", None, None
    if leaf == "weight" and len(shape) >= 4:  # flax lecun_normal of a patch-embed conv
        sigma = math.prod(shape[1:]) ** -0.5
        return "trunc", sigma, 2 * sigma / TRUNC_STD
    if leaf == "relative_position_bias_table":  # truncated_normal(0.02)
        return "trunc", 0.02 * TRUNC_STD, 0.04
    if name.startswith("clip_vision.") and leaf in ("class_embedding", "positional_embedding"):
        return "normal", vision_width ** -0.5, None
    if name.startswith("clip_text.") and leaf == "positional_embedding":
        return "normal", 0.01, None
    if leaf in ("visual_proj", "text_proj"):
        return "normal", shape[0] ** -0.5, None
    return "normal", 0.02, None


def _is_layernorm(model, name):
    from valor_tpu_torch.ops.layers import LayerNorm

    return "." in name and isinstance(model.get_submodule(name.rsplit(".", 1)[0]), LayerNorm)


def _laws(tcfg):
    """Port name -> law; LayerNorm scales are ones, their biases zeros."""
    from valor_tpu_torch.models.valor import VALORModel

    shapes = VALORModel(tcfg, device="meta")
    width = getattr(getattr(shapes, "clip_vision", None), "cfg", None)
    out = {}
    for name, p in shapes.named_parameters():
        if _is_layernorm(shapes, name):
            out[name] = ("ones" if name.endswith("weight") else "zeros", None, None)
        else:
            out[name] = LAW(name, tuple(p.shape), width.width if width is not None else 0)
    return out


def flagged(jax_sd, port_sd, laws):
    """Every key (or pool of small keys) whose statistics break the law, with why."""
    bad = []
    pools = {}
    for name, (kind, sigma, bound) in laws.items():
        j, t = jax_sd[name].double().flatten(), port_sd[name].double().flatten()
        if kind == "ones":
            if not (torch.equal(jax_sd[name], torch.ones_like(jax_sd[name]))
                    and torch.equal(port_sd[name], torch.ones_like(port_sd[name]))):
                bad.append((name, "not ones"))
            continue
        if kind == "zeros":
            if jax_sd[name].any() or port_sd[name].any():
                bad.append((name, "not zeros"))
            continue
        if kind == "const":
            if not torch.allclose(port_sd[name], jax_sd[name], rtol=1e-7, atol=0):
                bad.append((name, f"{port_sd[name]} != {jax_sd[name]}"))
            continue
        if j.numel() < SMALL:
            pj, pt = pools.setdefault((kind, sigma, bound), ([], []))
            pj.append(j)
            pt.append(t)
            continue
        bad += _check(name, j, t, kind, sigma, bound)
    for (kind, sigma, bound), (pj, pt) in pools.items():
        bad += _check(f"pool of {len(pj)} keys ({kind}, sigma {sigma:.4g})", torch.cat(pj), torch.cat(pt),
                      kind, sigma, bound)
    return bad


def _check(what, j, t, kind, sigma, bound):
    n = j.numel()
    out = []
    for who, x in (("jax", j), ("port", t)):
        if abs(float(x.mean())) > 5 * sigma / math.sqrt(n):
            out.append((what, f"{who} mean {float(x.mean()):.3g}, sigma {sigma:.3g}, n {n}"))
        if abs(float(x.std()) / sigma - 1) > 5 / math.sqrt(2 * n):
            out.append((what, f"{who} std {float(x.std()):.4g} against the law's {sigma:.4g}, n {n}"))
        peak = float(x.abs().max())
        if kind == "trunc" and not (0.9 * bound < peak <= bound * (1 + 1e-6)):
            out.append((what, f"{who} largest |x| {peak:.4g} against the cut at {bound:.4g}"))
        if kind == "normal" and n >= NORMAL_TAIL and peak < 2.2 * sigma:
            out.append((what, f"{who} largest |x| {peak:.4g}: no normal tail past 2.2 sigma"))
    if abs(float(t.std()) / float(j.std()) - 1) > 5 / math.sqrt(n):
        out.append((what, f"std port {float(t.std()):.4g} against jax {float(j.std()):.4g}, n {n}"))
    return out


def _jax_init(cfg_kw):
    """The JAX package's ``jax.jit(model.init)`` of a tiny config, as the port's keys."""
    import jax

    from tests.conftest import tiny_model_config
    from tests.test_torch_models import PT_TASK, _np, tiny_batch, torch_config
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu_torch.models.bridge import params_from_jax

    cfg = tiny_model_config(**cfg_kw)
    jm = JaxVALOR(cfg)
    spec = parse_task(PT_TASK)
    init = jax.jit(lambda r, b: jm.init(r, b, spec, True, True))
    params = init({"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)}, tiny_batch())["params"]
    return torch_config(cfg), params_from_jax(_np(params))


@pytest.fixture(scope="module", params=sorted(CASES))
def inits(request):
    tcfg, jax_sd = _jax_init(CASES[request.param])
    return request.param, tcfg, jax_sd


def test_jax_law_draws_what_jax_init_draws(inits):
    """Every key of ``init_params(law="jax")`` against ``jax.jit(model.init)``."""
    case, tcfg, jax_sd = inits
    port = init_params(tcfg, 0, "cpu", law="jax")
    assert set(port) == set(jax_sd)
    for k, v in port.items():
        assert v.shape == jax_sd[k].shape and v.dtype == torch.float32, k
    laws = _laws(tcfg)
    kinds = {kind for kind, _, _ in laws.values()}
    assert kinds == {"ones", "zeros", "const", "normal", "trunc"}, (case, kinds)
    assert flagged(jax_sd, port, laws) == []
    assert torch.equal(port[next(iter(port))], init_params(tcfg, 0, "cpu", law="jax")[next(iter(port))])


def test_sharp_law_is_not_the_jax_law(inits):
    """The sharp law, which tests and the smoke run's serving phases name for
    captions that depend on their media, breaks the JAX law (it was what
    ``cli.train`` drew before the JAX law)."""
    _, tcfg, jax_sd = inits
    sharp = init_params(tcfg, 0, "cpu")  # the default law stays sharp
    laws = _laws(tcfg)
    bad = {what for what, _ in flagged(jax_sd, sharp, laws)}
    assert any(".query.weight" in k for k in bad)
    assert "clip_vision.positional_embedding" in bad or "clip_vision.positional_embedding" not in laws


def test_unknown_law_raises():
    from tests.conftest import tiny_model_config
    from tests.test_torch_models import torch_config

    with pytest.raises(ValueError, match="init law 'flax'"):
        init_params(torch_config(tiny_model_config()), 0, "cpu", law="flax")


def test_cli_build_starts_from_the_jax_law(tmp_path, monkeypatch):
    """``build_model_and_state`` (``cli.train``) and ``model_weights``
    (``cli.serve``, ``cli.infer`` without a checkpoint) take the JAX law, from
    ``train.seed`` and seed 0; the sharp law is ``init_params``'s default,
    which only its direct callers take."""
    from tests.conftest import tiny_model_config
    from tests.test_torch_models import torch_config
    from valor_tpu_torch.cli.build import build_model_and_state, model_weights
    from valor_tpu_torch.core.config import Config, TrainConfig

    monkeypatch.setenv("VALOR_PRETRAINED_DIR", str(tmp_path / "none"))  # no public encoder files
    mcfg = torch_config(tiny_model_config())
    state = build_model_and_state(Config(model=mcfg, train=TrainConfig(seed=7)), "cpu")
    want = init_params(mcfg, 7, "cpu", law="jax")
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    served = model_weights(mcfg, None, "cpu")
    for k, v in init_params(mcfg, 0, "cpu", law="jax").items():
        assert torch.equal(served[k], v), k
    sharp = init_params(mcfg, 0, "cpu")  # the law the sharp-law callers name
    q = next(k for k in got if k.endswith("query.weight"))
    assert abs(float(got[q].std()) - 0.02) < 0.005 and abs(float(sharp[q].std()) - 0.02) > 0.05
    assert np.isclose(float(got["contra_temp"]), 0.07)
