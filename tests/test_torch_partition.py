"""The port's parameter placement (``valor_tpu_torch/parallel/partition.py``)
against the JAX package's ``shard_params`` and ``shard_opt_state`` on its 8 CPU
devices, with no process launched.

The tiny config is widened to ``fusion_hidden=128, fusion_intermediate=256``,
as ``tests/test_fsdp.py:test_composes_with_tp`` does, so that the fusion
tower's attention kernels reach the 2^14-element threshold of ``fsdp`` and
ZeRO-1.  On each mesh the port splits the same leaves over ``model`` and over
``data`` as JAX, on the same dim of the JAX layout, except the listed F11
leaves (ROADMAP Queue 3): a module whose heads do not divide by the model
axis stays whole, where JAX's spec splits its columns mid-head.  Each rank
holds 1/n of a split leaf, and the blocks of all ranks make the whole tensor.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from tests.conftest import tiny_model_config
from tests.test_torch_models import torch_config, tiny_batch
from valor_tpu.core.tasks import parse_task
from valor_tpu.models.valor import VALORModel as JaxVALOR
from valor_tpu.parallel import partition as JP
from valor_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from valor_tpu_torch.models.valor import VALORModel
from valor_tpu_torch.parallel import partition as PT

WIDE = dict(dropout=0.0, fusion_hidden=128, fusion_intermediate=256)
TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"
MESHES = {  # name: (n_data, n_model, fsdp, zero, config keys)
    "data2_fsdp": (2, 1, True, False, {}),
    "model2": (1, 2, False, False, {}),
    "data2_model2_fsdp_zero": (2, 2, True, True, {}),
    "data2_model2_zero": (2, 2, False, True, {}),
    "model2_swin": (1, 2, False, False, dict(video_encoder_type="videoswin_tiny_test")),
    "model2_one_audio_head": (1, 2, False, False, dict(audio_heads=1)),
    "model2_gqa": (1, 2, False, False, dict(fusion_heads=4, fusion_cross_attn_kv_heads=2)),
}
# the leaves JAX splits over the model axis and the port keeps whole (F11): the AST
# attention of one head, whose 32 columns divide by 2 and whose head does not
F11 = {"model2_one_audio_head": {f"audio_encoder/block_{i}/attn/{d}/{leaf}"
                                 for i in range(2) for d in ("query", "key", "value", "out")
                                 for leaf in ("kernel", "bias") if not (d == "out" and leaf == "bias")}}


def _jax_like(plan):
    """Each port parameter's split axes in the JAX layout, by JAX path: the
    axis of each JAX dim, or None."""
    out = {}
    for pl in plan.placements.values():
        jdims = PT.jax_dims(pl.path, len(pl.shape))
        axes = [None] * len(pl.shape)
        if pl.model_dim is not None:
            axes[jdims[pl.model_dim]] = MODEL_AXIS
        if pl.data_dim is not None:
            axes[jdims[pl.data_dim]] = DATA_AXIS
        out[pl.path] = tuple(axes)
    return out


def _cfg(extra):
    return tiny_model_config(**dict(WIDE, **extra))


def _jax_specs(cfg, n_data, n_model, fsdp, zero):
    """JAX path -> (spec of each JAX dim, JAX shape, ZeRO split) on the JAX
    package's mesh."""
    jm = JaxVALOR(cfg)
    shapes = jax.eval_shape(lambda r, b: jm.init(r, b, parse_task(TASK), True, True),
                            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                            tiny_batch())["params"]
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    mesh = make_mesh(n_data, n_model, devices=jax.devices()[: n_data * n_model])
    placed = JP.shard_params(zeros, mesh, fsdp=fsdp)
    moments = JP.shard_opt_state(placed, placed, mesh) if zero else placed
    sizes = {DATA_AXIS: n_data, MODEL_AXIS: n_model, None: 1}

    def split(spec):  # an axis of one device splits nothing
        return tuple(a if sizes[a] > 1 else None for a in spec)

    out = {}
    for (path, x), m in zip(jax.tree_util.tree_flatten_with_path(placed)[0], jax.tree_util.tree_leaves(moments)):
        spec = split(tuple(x.sharding.spec) + (None,) * (x.ndim - len(x.sharding.spec)))
        mspec = split(tuple(m.sharding.spec))
        out[JP._path_str(path)] = (spec, tuple(x.shape), DATA_AXIS in mspec and DATA_AXIS not in spec)
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    n_data, n_model, fsdp, zero, extra = MESHES[request.param]
    cfg = _cfg(extra)
    model = VALORModel(torch_config(cfg), device="meta")
    plan = PT.plan(model, n_data, n_model, fsdp)
    return request.param, plan, _jax_specs(cfg, n_data, n_model, fsdp, zero), model


def test_same_leaves_split_as_jax(case):
    name, plan, jax_specs, _ = case
    port = _jax_like(plan)
    assert port.keys() == jax_specs.keys()
    f11 = F11.get(name, set())
    assert set(plan.f11) == f11
    for path, axes in port.items():
        want = jax_specs[path][0]
        if path in f11:
            want = tuple(None if a == MODEL_AXIS else a for a in want)
        assert axes == want, f"{name}: {path} port {axes} JAX {want}"


def test_zero_splits_what_jax_shard_opt_state_splits(case):
    name, plan, jax_specs, _ = case
    zero = MESHES[name][3]
    for pl in plan.placements.values():
        assert (zero and PT.zero_split(pl, plan.n_data)) == jax_specs[pl.path][2], f"{name}: {pl.path}"


def test_each_rank_holds_its_share(case):
    """Rank (d, m)'s block holds 1/n of a split leaf, n the ranks of its axes,
    and the blocks of every rank put back together are the whole tensor."""
    name, plan, jax_specs, _ = case
    gen = torch.Generator().manual_seed(0)
    n_split = 0
    for pl in plan.placements.values():
        if not pl.split:
            continue
        n_split += 1
        t = torch.randn(pl.shape, generator=gen)
        n = (plan.n_model if pl.model_dim is not None else 1) * (plan.n_data if pl.data_dim is not None else 1)
        blocks = {(d, m): PT.local(t, pl, m, plan.n_model, d, plan.n_data)
                  for d in range(plan.n_data) for m in range(plan.n_model)}
        for b in blocks.values():
            assert b.numel() * n == t.numel(), f"{name}: {pl.path}"
        cols = []
        for m in range(plan.n_model):
            col = [blocks[(d, m)] for d in range(plan.n_data)]
            cols.append(torch.cat(col, pl.data_dim) if pl.data_dim is not None else col[0])
        back = PT._join(cols, pl.model_dim, pl.model_groups) if pl.model_dim is not None else cols[0]
        assert torch.equal(back, t), f"{name}: {pl.path}"
    assert n_split


def test_tensor_parallel_modules_and_partial_tables(case):
    name, plan, _, model = case
    _, n_model, _, _, extra = MESHES[name]
    if n_model == 1:
        assert not plan.tp and not any(p.model_dim is not None for p in plan.placements.values())
        return
    kinds = set(plan.tp.values())
    assert {"attention", "mlp"} <= kinds
    partial = {n for n, p in plan.placements.items() if p.model_partial}
    if "video_encoder_type" in extra:
        assert "window" in kinds and partial and all(n.endswith("relative_position_bias_table") for n in partial)
        qkv = [p for n, p in plan.placements.items() if n.endswith("attn.qkv.weight")]
        assert qkv and all(p.model_groups == 3 for p in qkv)
    else:
        assert not partial
    if "audio_heads" in extra:
        assert not any(n.startswith("audio_encoder") and "attn" in n for n in plan.tp)


@pytest.mark.parametrize("path,ndim,want", [
    ("multimodal_encoder/layer_0/self_attn/attn/query/kernel", 2, (None, MODEL_AXIS)),
    ("multimodal_encoder/layer_0/self_attn/attn/query/bias", 1, (MODEL_AXIS,)),
    ("multimodal_encoder/layer_0/cross_attn_v/attn/key/kernel", 2, (None, MODEL_AXIS)),
    ("multimodal_encoder/layer_0/self_attn/attn/out/kernel", 2, (MODEL_AXIS, None)),
    ("multimodal_encoder/layer_0/self_attn/attn/out/bias", 1, ()),
    ("multimodal_encoder/layer_0/self_attn/ln/scale", 1, ()),
    ("multimodal_encoder/layer_0/mlp/fc1/kernel", 2, (None, MODEL_AXIS)),
    ("multimodal_encoder/layer_0/mlp/fc1/bias", 1, (MODEL_AXIS,)),
    ("multimodal_encoder/layer_0/mlp/fc2/kernel", 2, (MODEL_AXIS, None)),
    ("multimodal_encoder/layer_0/mlp/fc2/bias", 1, ()),
    ("multimodal_encoder/layer_1/moe_mlp/w1", 3, ()),
    ("video_encoder/layers_0/blocks_0/attn/qkv/kernel", 2, (None, MODEL_AXIS)),
    ("video_encoder/layers_0/blocks_0/attn/proj/kernel", 2, (MODEL_AXIS, None)),
    ("video_encoder/layers_0/blocks_0/attn/relative_position_bias_table", 2, ()),
    ("clip_vision/block_0/attn/value/kernel", 2, (None, MODEL_AXIS)),
    ("multimodal_encoder/embeddings/word_embeddings", 2, ()),
    ("clip_vision/patch_embed/kernel", 4, ()),
])
def test_param_spec_path_by_path(path, ndim, want):
    assert PT.param_spec(path, ndim) == want
    assert tuple(JP.param_spec(path, ndim)) == want


def test_layouts_map_to_jax_dims():
    assert PT.jax_dims("a/query/kernel", 2) == [1, 0]  # [out, in] holds [in, out]
    assert PT.jax_dims("a/patch_embed/kernel", 4) == [3, 2, 0, 1]  # OIHW holds HWIO
    assert PT.jax_dims("a/patch_embed/kernel", 5) == [4, 3, 0, 1, 2]
    assert PT.jax_dims("a/word_embeddings", 2) == [0, 1]
