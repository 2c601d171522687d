"""The parameter axes across processes: ``fsdp`` and tensor parallelism
(``model_shards``) on four gloo ranks on the CPU, against one port process
on the global batch and against the JAX package's step.

One four-rank launch (``parallel/launch.py:run_local``) runs, in turn, the
meshes (data 4 x model 1) with ``fsdp``, (2 x 2) and (2 x 2) with ``fsdp``
and ``zero_optimizer``, on the tiny config widened to ``fusion_hidden=128,
fusion_intermediate=256`` (as ``tests/test_fsdp.py`` widens it) so that the
fusion tower's attention and MLP kernels and the tied word table reach the
2^14-element threshold of ``fsdp``, with four fusion layers (the pipelined
flows below split them into stages and share these meshes' references).  At each mesh:

  * one ``pt_contra%tva%tv%ta_caption%tva%tv%ta`` step with dropout and the
    unimlm masks drawn: every loss, the grad norm and every updated parameter
    (gathered whole) within 1e-5 of one port process on the global batch;
  * the same step with dropout off and the masks patched by a row-local
    pattern in both packages (a rank's rows mask as they do in the global
    batch): the losses and grad norm within 1e-4 of JAX's, and the updated
    parameters within the learning rate of JAX's update
    (``tests/test_torch_moe.py:test_one_train_step_matches_jax``'s bound);
  * ``validate_ret`` reports equal to one process's, and a greedy
    ``validate_cap`` whose captions (decoded from local-head caches) equal
    one process's token for token;
  * one SCST step (``Trainer.scst_step``, unpatched rollouts): rewards and
    alpha equal on every rank and to one process's;
  * a whole checkpoint written at the mesh, resumed at another of the three
    meshes and in one process: the restored parameters and moments bit for
    bit the file's, and the next step's losses within 1e-5.

Two more steps at (2 x 2): VideoSwin (its relative-position bias tables are
replicated but read by heads, so their gradients are partial on each model
rank and summed over the model axis; the test checks both), and grouped-query
cross-attention with kv_heads divisible by the model axis.

Then expert and sequence parallelism over the model axis at (2 x 2): ``ep_2x2``
(``fusion_moe_experts=4, fusion_moe_every=2``: two experts a model rank),
``sp_2x2`` (``sequence_parallel``, dense) and ``ep_sp_fsdp_2x2`` (MoE,
``sequence_parallel`` and ``fsdp``).  The batch's text is 8 tokens, so every
fusion sequence of the step (8 text tokens; 16 in the full-masker halves of
``unimlm``) divides the model axis and sequence parallelism engages.  Each
flow's step, with ``moe_aux``: the losses, the grad norm, every updated
parameter and each model rank's router gradient within 1e-5 of one port
process; the same step with dropout off and the row-local masks within 1e-4 of
JAX's single-device step (losses and grad norm; ``sp_2x2``'s updated
parameters within the learning rate of JAX's update too); both counts above 0 on every rank where the flow
switches them on.  ``ep_sp_fsdp_2x2`` also validates (greedy captions token for
token), runs one SCST step (rewards and alpha equal to one process's) and
writes a whole checkpoint that resumes at ``tp_2x2`` and in one process.

Last, pipeline parallelism of the fusion stack over a pipe axis
(``parallel/pipeline.py``), with ``fusion_layers=4``: ``pp_2x1x2`` (data 2 x
pipe 2, GPipe, ``fsdp`` and ``zero_optimizer``; the global batch of 8 spreads
over data x pipe, 2 rows a rank), ``pp_1x2x2_v2`` (model 2 x pipe 2, the
interleaved schedule with 2 chunks a device), and ``pp_zero_2x1x2``
(``pp_2x1x2`` with ZeRO-1 alone, whose split leaves ``fsdp`` would have
taken).  Each flow: the stack ran
pipelined on every rank; the step with dropout and masks drawn within 1e-5 of
one port process (losses, grad norm, every updated parameter); with dropout
off and the row-local masks within 1e-4 of JAX's single-device step (losses
and grad norm).  ``pp_2x1x2`` also validates (reports and greedy captions equal
one process's; the evaluation forward runs the stack whole), runs one SCST
step (rewards and alpha equal) and writes a whole checkpoint that resumes at
``tp_2x2`` and in one process (restored bit for bit, the next step within
1e-5).
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_ddp import PT_TASK, UPDATE, _batch
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.launch import run_local

WORLD = 4
LIMIT = 420
TOL = 1e-5
TOL_JAX = 1e-4
SEED = 7
WIDE = dict(fusion_hidden=128, fusion_intermediate=256)
MESHES = {  # name: (model_shards, fsdp, zero_optimizer)
    "fsdp_4x1": (1, True, False),
    "tp_2x2": (2, False, False),
    "tp_fsdp_zero_2x2": (2, True, True),
}
RESUME = {"fsdp_4x1": "tp_2x2", "tp_2x2": "tp_fsdp_zero_2x2", "tp_fsdp_zero_2x2": "fsdp_4x1"}
EP_SP = {  # name: (config, model_shards, fsdp)
    "ep_2x2": ("moe", 2, False),
    "sp_2x2": ("sp", 2, False),
    "ep_sp_fsdp_2x2": ("moe_sp", 2, True),
}
EP_SP_RESUME = ("ep_sp_fsdp_2x2", "tp_2x2")  # the flow whose checkpoint resumes, and where
PP = {  # name: (model_shards, pipe stages, fsdp, zero_optimizer, config)
    "pp_2x1x2": (1, 2, True, True, "pp"),
    "pp_1x2x2_v2": (2, 2, False, False, "pp_v2"),
    "pp_zero_2x1x2": (1, 2, False, True, "pp"),  # ZeRO-1 splits leaves that fsdp leaves whole
}
PP_RESUME = ("pp_2x1x2", "tp_2x2")
PP_CFG = dict(fusion_layers=4, fusion_pipeline_stages=2)
MOE = dict(fusion_moe_experts=4, fusion_moe_every=2)
EVAL_IDS = [f"v{i}" for i in range(6)]
SCST_IDS = ["a", "b", "c", "d", "a", "d", "b", "c"]


def _cfg(**kw):
    from tests.test_torch_ddp import _cfg as cfg

    return cfg(**dict(WIDE, **kw))


class IdTokenizer:
    """Decodes ids as their numbers: captions compared token for token."""

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _row_mask_torch(gen, tokens, *a):
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    pick = (((tokens.long() * 7 + pos * 3) % 5) < 2) & (tokens != 0)
    pick[:, 0], pick[:, 1] = False, True
    return torch.where(pick, 103, tokens).to(tokens.dtype), torch.where(pick, tokens, -1).to(tokens.dtype)


def _row_mask_jax(rng, tokens, *a):
    import jax.numpy as jnp

    pos = jnp.arange(tokens.shape[1])[None]
    pick = (((tokens * 7 + pos * 3) % 5) < 2) & (tokens != 0)
    pick = pick.at[:, 0].set(False).at[:, 1].set(True)
    return jnp.where(pick, 103, tokens).astype(tokens.dtype), jnp.where(pick, tokens, -1).astype(tokens.dtype)


def _state(cfg, fsdp=False, zero=False):
    """A training state from seed 0's weights, placed on this process's mesh
    with the config's expert and sequence parallelism switches."""
    from valor_tpu_torch.cli.build import install_mesh_switches
    from valor_tpu_torch.core.config import TrainConfig
    from valor_tpu_torch.models.bridge import init_params, train_model
    from valor_tpu_torch.parallel.partition import shard_model
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState

    model = train_model(cfg, init_params(cfg, 0, "cpu"), "cpu")
    shard_model(model, fsdp=fsdp)
    install_mesh_switches(cfg)
    return TrainState(model, build_optimizer(model, TrainConfig(**UPDATE, zero_optimizer=zero)))


def _rows(batch):
    """This rank's rows of a global batch (its batch axis's: the data rank's,
    or its (data, pipe) place's where the pipe folds into the batch)."""
    d, n = P.batch_rank(), P.batch_world()
    return {k: v[d::n] for k, v in batch.items()}


def _tensors(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def _step(state, batch, task=PT_TASK):
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.train.step import train_step

    return {k: float(v) for k, v in train_step(state, _tensors(batch), parse_task(task), SEED).items()}


def _routed_step(state, batch, cfg):
    """``_step`` with the config's ``moe_aux`` weight; also each router's
    gradient as ``reduce_grads`` hands it to the update, and how many forwards
    ran expert- and sequence-split."""
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.ops.moe import expert_sharding_applied
    from valor_tpu_torch.parallel.activations import sequence_sharding_applied
    from valor_tpu_torch.train.step import moe_aux_weight_for, train_step

    names = [n for n, _ in state.model.named_parameters()]
    reduce0, routers = state.optimizer.reduce_grads, {}

    def reduce(grads):
        out = reduce0(grads)
        routers.update({n: g.clone() for n, g in zip(names, out) if n.endswith(".router")})
        return out

    counts0 = (expert_sharding_applied(), sequence_sharding_applied())
    state.optimizer.reduce_grads = reduce
    try:
        metrics = train_step(state, _tensors(batch), parse_task(PT_TASK), SEED, moe_aux_weight=moe_aux_weight_for(cfg))
    finally:
        del state.optimizer.reduce_grads
    counts = (expert_sharding_applied() - counts0[0], sequence_sharding_applied() - counts0[1])
    return {k: float(v) for k, v in metrics.items()}, routers, counts


def _whole(state):
    """The parameters and the optimizer's moments as a checkpoint takes them
    (rank 0's are whole)."""
    from valor_tpu_torch.parallel.partition import whole_state_dict

    opt = state.optimizer.state_dict()
    return {"params": {k: v.detach().clone() for k, v in whole_state_dict(state.model).items()},
            "mu": [t.detach().clone() for t in opt["mu"]], "nu": [t.detach().clone() for t in opt["nu"]]}


def _kept(x):
    """Rank 0's copy of what every rank gathered (the others return None)."""
    return x if P.rank() == 0 else None


def _validate(model, cfg, eval_batch, result_dir):
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.eval import validate as V
    from valor_tpu_torch.train.step import eval_step

    rows = _rows(dict(eval_batch, ids=np.array(EVAL_IDS)))
    ids = [str(i) for i in rows.pop("ids")]
    ret = V.validate_ret(model, eval_step, [dict(_tensors(rows), ids=ids)], parse_task("ret%tva%tv"),
                         cfg.contra_type)
    media = {k: rows[k] for k in ("video_pixels", "audio_spectrograms")}
    hyps = {}
    import valor_tpu_torch.eval.validate as VM

    dump0 = VM._dump
    VM._dump = lambda path, payload: hyps.update({os.path.basename(path): payload})
    try:
        cap = V.validate_cap(model, [dict(_tensors(media), ids=ids)], parse_task("cap%tva"), IdTokenizer(),
                             {i: ["1 2 3"] for i in EVAL_IDS}, caption_type=cfg.caption_type,
                             max_len=cfg.max_generation_len, result_dir=result_dir, step=0)
    finally:
        VM._dump = dump0
    return {"ret": ret, "cap": cap, "hyps": hyps}


def _scst(cfg, fsdp, zero, batch, ids, ann, vocab):
    """One SCST step: the advantages of each update, alpha and the metrics."""
    import valor_tpu_torch.train.trainer as T
    from valor_tpu_torch.core.config import Config, TrainConfig
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.scorer import AdaptiveAlpha, Scorer

    state = _state(cfg, fsdp, zero)
    tcfg = TrainConfig(**UPDATE, zero_optimizer=zero)
    trainer = T.Trainer(Config(model=cfg, train=tcfg), state, [], scorer=Scorer(ann, sorted(set(SCST_IDS)),
                                                                                 BertTokenizer(vocab)))
    trainer.alpha = AdaptiveAlpha(alpha_type=2, beta=0.9)
    rewards, update0 = [], T.scst_update

    def update(*a, **kw):
        rewards.append(a[3].detach().clone())
        return update0(*a, **kw)

    T.scst_update = update
    try:
        metrics = trainer.scst_step(_tensors(batch), ids, parse_task("cap%tva%tv"))
    finally:
        T.scst_update = update0
    a = trainer.alpha
    return {"rewards": rewards, "alpha": (a.value(), a.idx, a.sample_total, a.greedy_total),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _partial_table_step(cfg, batch):
    """A VideoSwin step: each bias table's gradient on this rank before and
    after ``reduce_grads``, the losses and the updated parameters."""
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.parallel.partition import whole_state_dict
    from valor_tpu_torch.train.step import losses_and_grads

    state = _state(cfg)
    names = [n for n, _ in state.model.named_parameters()]
    metrics, raw = losses_and_grads(state.model, _tensors(batch), parse_task("pt_contra%tva_caption%tva"), SEED,
                                    reduce_grads=lambda g: g)
    tables = [i for i, n in enumerate(names) if n.endswith("relative_position_bias_table")]
    local = {names[i]: raw[i].clone() for i in tables}
    grads = state.optimizer.reduce_grads(raw)
    state.optimizer.update(grads)
    return {"local": local, "reduced": {names[i]: grads[i].clone() for i in tables},
            "metrics": {k: float(v) for k, v in metrics.items()}, "params": _kept(whole_state_dict(state.model))}


def _rank(cfgs, batches, eval_batch, scst, root):
    import valor_tpu_torch.models.valor as TV
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state

    P.init_data_parallel("gloo", "cpu")
    out = {}
    for name, (m, fsdp, zero) in MESHES.items():
        P.make_mesh(m, "cpu")
        o = out[name] = {}
        state = _state(cfgs["main"], fsdp, zero)
        o["held"] = {n: p.numel() for n, p in state.model.named_parameters()}
        o["split"] = {n: (pl.model_dim, pl.data_dim) for n, pl in state.model.placements.items() if pl.split}
        o["zero"] = [bool(s) for s in state.optimizer.sharded]
        o["grid"] = (P.data_rank(), P.data_world(), P.model_rank(), P.model_world())
        o["rows"] = (P.batch_rank(), P.batch_world())
        state.model.eval()
        o["eval"] = _validate(state.model, cfgs["main"], eval_batch, os.path.join(root, "results"))
        state.model.train()
        o["step"] = _step(state, _rows(batches[0]))
        o["after"] = _kept(_whole(state)["params"])
        ModelSaver(os.path.join(root, name)).save(state, 1)
        mask0 = TV.mask_tokens
        TV.mask_tokens = _row_mask_torch
        try:
            jstate = _state(cfgs["jax"], fsdp, zero)
            o["jax_step"] = _step(jstate, _rows(batches[0]))
            o["jax_after"] = _kept(_whole(jstate)["params"])
        finally:
            TV.mask_tokens = mask0
        o["scst"] = _scst(cfgs["main"], fsdp, zero, _rows(scst["batch"]), _rows({"i": np.array(SCST_IDS)})["i"].tolist(),
                          scst["ann"], scst["vocab"])
    for src, dst in RESUME.items():
        m, fsdp, zero = MESHES[dst]
        P.make_mesh(m, "cpu")
        state = _state(cfgs["main"], fsdp, zero)
        load_state(state, ModelSaver(os.path.join(root, src)).restore())
        out[src]["restored_at"] = dst
        out[src]["restored"] = _kept(_whole(state))
        out[src]["resumed_step"] = _step(state, _rows(batches[1]))
    P.make_mesh(2, "cpu")
    out["swin"] = _partial_table_step(cfgs["swin"], _rows(batches[0]))
    gqa = _state(cfgs["gqa"])
    out["gqa"] = {"step": _step(gqa, _rows(batches[0])), "after": _kept(_whole(gqa)["params"])}
    for name, (key, m, fsdp) in EP_SP.items():
        P.make_mesh(m, "cpu")
        o = out[name] = {}
        state = _state(cfgs[key], fsdp)
        if name == EP_SP_RESUME[0]:
            state.model.eval()
            o["eval"] = _validate(state.model, cfgs[key], eval_batch, os.path.join(root, "results_" + name))
            state.model.train()
        o["step"], o["routers"], o["counts"] = _routed_step(state, _rows(batches[0]), cfgs[key])
        o["after"] = _kept(_whole(state)["params"])
        if name == EP_SP_RESUME[0]:
            ModelSaver(os.path.join(root, name)).save(state, 1)
            o["scst"] = _scst(cfgs[key], fsdp, False, _rows(scst["batch"]),
                              _rows({"i": np.array(SCST_IDS)})["i"].tolist(), scst["ann"], scst["vocab"])
        mask0 = TV.mask_tokens
        TV.mask_tokens = _row_mask_torch
        try:
            jstate = _state(cfgs[key + "_jax"], fsdp)
            o["jax_step"] = _routed_step(jstate, _rows(batches[0]), cfgs[key])[0]
            o["jax_after"] = _kept(_whole(jstate)["params"])
        finally:
            TV.mask_tokens = mask0
    src, dst = EP_SP_RESUME
    m, fsdp, zero = MESHES[dst]
    P.make_mesh(m, "cpu")
    state = _state(cfgs["moe"], fsdp, zero)
    load_state(state, ModelSaver(os.path.join(root, src)).restore())
    out[src]["restored"] = _kept(_whole(state))
    out[src]["resumed_step"] = _routed_step(state, _rows(batches[1]), cfgs["moe"])[0]
    for name, (m, s, fsdp, zero, key) in PP.items():
        out[name] = _pp_flow(name, m, s, fsdp, zero, cfgs[key], cfgs["pp_jax"], batches[0], eval_batch, scst, root)
    src, dst = PP_RESUME
    P.make_mesh(MESHES[dst][0], "cpu")
    state = _state(cfgs["pp"], *MESHES[dst][1:])
    load_state(state, ModelSaver(os.path.join(root, src)).restore())
    out[src]["restored"] = _kept(_whole(state))
    out[src]["resumed_step"] = _step(state, _rows(batches[1]))
    return out


def _pp_flow(name, m, s, fsdp, zero, cfg, jax_cfg, batch, eval_batch, scst, root):
    """One pipelined flow on a (data, model, pipe) grid of ``m`` model and
    ``s`` pipe ranks: its place, how many stack forwards ran pipelined, the
    step, and for ``PP_RESUME``'s flow the validation, a checkpoint and an
    SCST step; then the step of JAX's config with the row-local masks."""
    import valor_tpu_torch.models.valor as TV
    from valor_tpu_torch.parallel.pipeline import pipeline_applied
    from valor_tpu_torch.train.checkpoints import ModelSaver

    P.make_mesh(m, "cpu", s)
    o = {"grid": (P.data_rank(), P.model_rank(), P.pipe_rank(), P.pipe_world()),
         "rows": (P.batch_rank(), P.batch_world())}
    state = _state(cfg, fsdp, zero)
    if name == PP_RESUME[0]:
        state.model.eval()
        o["eval"] = _validate(state.model, cfg, eval_batch, os.path.join(root, "results_" + name))
        state.model.train()
        o["eval_applied"] = pipeline_applied()
    o["zero_split"] = sum(state.optimizer.sharded)
    o["step"] = _step(state, _rows(batch))
    o["applied"] = pipeline_applied()
    o["after"] = _kept(_whole(state)["params"])
    if name == PP_RESUME[0]:
        ModelSaver(os.path.join(root, name)).save(state, 1)
        o["scst"] = _scst(cfg, fsdp, zero, _rows(scst["batch"]), _rows({"i": np.array(SCST_IDS)})["i"].tolist(),
                          scst["ann"], scst["vocab"])
    mask0 = TV.mask_tokens
    TV.mask_tokens = _row_mask_torch
    try:
        jstate = _state(jax_cfg, fsdp, zero)
        o["jax_step"] = _step(jstate, _rows(batch))
    finally:
        TV.mask_tokens = mask0
    return o


def _one_scst(cfg, batch, ann, vocab):
    return _scst(cfg, False, False, batch, list(SCST_IDS), ann, vocab)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import json

    from tests.test_data import TINY_VOCAB
    from valor_tpu_torch.cli.build import install_mesh_switches
    from valor_tpu_torch.train.checkpoints import ModelSaver, load_state

    root = tmp_path_factory.mktemp("fsdp_tp")
    (root / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    ann = {"a": ["A cat sits on the mat.", "the cat sits"], "b": ["The dog runs"], "c": "the mat",
           "d": ["a dog sits on the cat", "dogs run"]}
    (root / "ann.json").write_text(json.dumps(ann))
    # four fusion layers: the pipelined flows split them into 2 stages (x 2 chunks), and they share the one
    # process and JAX references of the dense meshes (the pipeline knobs change neither's arithmetic)
    cfgs = {"main": _cfg(dropout=0.1, caption_type="unimlm", fusion_layers=4),
            "jax": _cfg(dropout=0.0, caption_type="unimlm", fusion_layers=4),
            "swin": _cfg(dropout=0.0, caption_type="lm", video_encoder_type="videoswin_tiny_test",
                         txt_encoder_type="bert_base_uncased", init_clip_head=False),
            "gqa": _cfg(dropout=0.1, caption_type="unimlm", fusion_heads=4, fusion_cross_attn_kv_heads=2)}
    for key, kw in {"moe": MOE, "sp": dict(sequence_parallel=True, fusion_layers=4),
                    "moe_sp": dict(MOE, sequence_parallel=True), "pp": PP_CFG}.items():
        cfgs[key] = _cfg(dropout=0.1, caption_type="unimlm", **kw)
        cfgs[key + "_jax"] = _cfg(dropout=0.0, caption_type="unimlm", **kw)
    cfgs["pp_v2"] = _cfg(dropout=0.1, caption_type="unimlm", fusion_pipeline_interleave=2, **PP_CFG)
    batches = [_batch(60), _batch(61)]
    eval_batch = _batch(62, b=6)
    scst = {"batch": {k: v for k, v in _batch(63).items() if k in ("video_pixels", "audio_spectrograms")},
            "ann": str(root / "ann.json"), "vocab": str(root / "vocab.txt")}
    ranks = run_local(_rank, WORLD, cfgs, batches, eval_batch, scst, str(root / "ckpt"), timeout=LIMIT)
    # one process on the global batches
    one = _state(cfgs["main"])
    one_eval = _validate(one.model.eval(), cfgs["main"], eval_batch, str(root / "results"))
    one.model.train()
    one_step = _step(one, batches[0])
    one_after = _whole(one)["params"]
    one_scst = _one_scst(cfgs["main"], scst["batch"], scst["ann"], scst["vocab"])
    resumed = {}
    for src in MESHES:
        payload = ModelSaver(str(root / "ckpt" / src)).restore()
        st = _state(cfgs["main"])
        load_state(st, payload)
        resumed[src] = {"payload": payload, "restored": _whole(st), "step": _step(st, batches[1])}
    swin_one = _partial_table_step(cfgs["swin"], batches[0])
    gqa = _state(cfgs["gqa"])
    gqa_one = {"step": _step(gqa, batches[0]), "after": _whole(gqa)["params"]}
    ep_sp_one = {}
    for key in ("moe", "sp", "moe_sp"):
        st = _state(cfgs[key])
        o = ep_sp_one[key] = {}
        if key == "moe_sp":
            o["eval"] = _validate(st.model.eval(), cfgs[key], eval_batch, str(root / "results_one_moe"))
            st.model.train()
            o["scst"] = _one_scst(cfgs[key], scst["batch"], scst["ann"], scst["vocab"])
        o["step"], o["routers"], o["counts"] = _routed_step(st, batches[0], cfgs[key])
        o["after"] = _whole(st)["params"]
    payload = ModelSaver(str(root / "ckpt" / EP_SP_RESUME[0])).restore()
    st = _state(cfgs["moe"])
    load_state(st, payload)
    ep_sp_one["resumed"] = {"payload": payload, "restored": _whole(st),
                            "step": _routed_step(st, batches[1], cfgs["moe"])[0]}
    payload = ModelSaver(str(root / "ckpt" / PP_RESUME[0])).restore()
    st = _state(cfgs["pp"])
    load_state(st, payload)
    pp_one = {"resumed": {"payload": payload, "restored": _whole(st), "step": _step(st, batches[1])}}
    install_mesh_switches(cfgs["main"])  # all off again for the tests that follow in this process
    return {"ranks": ranks, "cfgs": cfgs, "batches": batches, "one_eval": one_eval, "one_step": one_step,
            "one_after": one_after, "one_scst": one_scst, "resumed": resumed, "swin_one": swin_one,
            "gqa_one": gqa_one, "ep_sp_one": ep_sp_one, "pp_one": pp_one}


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=what)


def _metrics_close(got, want, tol, what):
    assert got.keys() == want.keys(), what
    for k in want:
        _close(got[k], want[k], tol, f"{what} {k}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_share(run, mesh):
    m, fsdp, _ = MESHES[mesh]
    whole = {k: v.numel() for k, v in run["one_after"].items()}
    for r, out in enumerate(run["ranks"]):
        o = out[mesh]
        assert o["grid"] == (r // m, WORLD // m, r % m, m)
        assert o["split"], mesh
        assert any(d is not None for _, d in o["split"].values()) == fsdp
        assert any(md is not None for md, _ in o["split"].values()) == (m > 1)
        for n, (md, dd) in o["split"].items():
            parts = (m if md is not None else 1) * (WORLD // m if dd is not None else 1)
            assert o["held"][n] * parts == whole[n], n
        assert sum(o["held"].values()) < sum(whole.values())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_equals_one_process(run, mesh):
    for out in run["ranks"]:
        _metrics_close(out[mesh]["step"], run["one_step"], TOL, mesh)
    after = run["ranks"][0][mesh]["after"]
    assert after.keys() == run["one_after"].keys()
    for n, p in run["one_after"].items():
        _close(after[n], p, TOL, f"{mesh} updated {n}")


def _jax_reference(run, key, update=True):
    """JAX's losses, grad norm and (with ``update``; else None) updated
    parameters of config ``key`` on the global batch (with its ``moe_aux``),
    with the port's seed-0 weights and the row-local masks."""
    import jax
    import jax.numpy as jnp
    import optax

    import valor_tpu.models.valor as JV
    from tests.test_torch_models import _np, jax_layout, jax_shapes
    from valor_tpu.core.config import TrainConfig as JaxTrainConfig
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu.train.optimizer import build_optimizer as jax_build
    from valor_tpu.train.step import _apply_losses
    from valor_tpu_torch.models.bridge import init_params, params_from_jax
    from valor_tpu_torch.train.step import moe_aux_weight_for
    import dataclasses

    from valor_tpu.core.config import ModelConfig as JaxModelConfig

    cfg = run["cfgs"][key]
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jm = JaxVALOR(jcfg)
    params = jax_layout(init_params(cfg, 0, "cpu"), jax_shapes(jm, PT_TASK))
    spec = parse_task(PT_TASK)
    batch = {k: jnp.asarray(v) for k, v in run["batches"][0].items()}
    mask0 = JV.mask_tokens
    JV.mask_tokens = _row_mask_jax
    try:
        def loss(p):
            losses = _apply_losses(jm, p, batch, spec, {"mask": jax.random.PRNGKey(0)}, moe_aux_weight_for(cfg))
            return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), losses

        (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    finally:
        JV.mask_tokens = mask0
    metrics = {k: float(v) for k, v in losses.items()}
    metrics.update(total_loss=float(total), grad_norm=float(optax.global_norm(grads)))
    if not update:
        return metrics, None
    tx = jax_build(params, JaxTrainConfig(**UPDATE))
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    return metrics, params_from_jax(_np(optax.apply_updates(params, updates)))


@pytest.fixture(scope="module")
def jax_ref(run):
    """JAX's step of the dense config (``_jax_reference``)."""
    return _jax_reference(run, "jax")


@pytest.fixture(scope="module")
def jax_moe_ref(run):
    """JAX's losses and grad norm of the MoE config, with ``moe_aux`` (the MoE
    flows' updates are held to one port process, whose update
    ``tests/test_torch_moe.py`` holds to JAX's)."""
    return _jax_reference(run, "moe_jax", update=False)


def _against_jax(got_ranks, ref, what):
    """Every rank's step within ``TOL_JAX`` of JAX's, and rank 0's updated
    parameters within the learning rate of JAX's update, where it has one."""
    metrics, after = ref
    lr = UPDATE["learning_rate"]
    for step, _ in got_ranks:
        _metrics_close(step, metrics, TOL_JAX, f"{what} against JAX")
    if after is None:
        return
    got = got_ranks[0][1]
    assert got.keys() == after.keys()
    diff = torch.cat([(got[n] - p).abs().reshape(-1) for n, p in after.items()])
    assert float(diff.max()) <= lr
    assert float((diff <= 2e-2 * lr).float().mean()) >= 0.999


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_equals_jax(run, jax_ref, mesh):
    _against_jax([(out[mesh]["jax_step"], out[mesh]["jax_after"]) for out in run["ranks"]], jax_ref, mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_validation_reports_and_captions_equal(run, mesh):
    one = run["one_eval"]
    assert one["hyps"] and len({json_seq for v in one["hyps"].values() for json_seq in
                                (str(x["caption"]) for x in v)}) > 1
    for out in run["ranks"]:
        got = out[mesh]["eval"]
        assert got["ret"] == one["ret"]
        assert got["cap"] == one["cap"]
    got = run["ranks"][0][mesh]["eval"]["hyps"]  # rank 0 wrote the dumps
    assert {k: sorted(v, key=lambda x: x["video_id"]) for k, v in got.items()} == \
        {k: sorted(v, key=lambda x: x["video_id"]) for k, v in one["hyps"].items()}


def _scst_equal(got_ranks, one, rows):
    """Every rank's SCST alpha and rewards equal one process's, its other
    metrics within ``TOL``, and its advantages its rows of one process's
    (``rows``: each rank's (batch rank, batch world))."""
    assert len(one["rewards"]) == 2
    for got in got_ranks:
        assert got["alpha"] == one["alpha"]
        assert got["metrics"].keys() == one["metrics"].keys()
        for k, v in one["metrics"].items():
            if k.startswith("scst_reward"):
                assert got["metrics"][k] == v, k
            else:
                _close(got["metrics"][k], v, TOL, k)
    for got, (d, n) in zip(got_ranks, rows):
        for mine, whole in zip(got["rewards"], one["rewards"]):
            _close(mine, whole[d::n], 1e-12, "advantage")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_scst_rewards_and_alpha_equal(run, mesh):
    _scst_equal([out[mesh]["scst"] for out in run["ranks"]], run["one_scst"], [out[mesh]["rows"] for out in run["ranks"]])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_checkpoint_resumes_at_another_mesh_and_in_one_process(run, mesh):
    res = run["resumed"][mesh]
    payload = res["payload"]
    # every tensor of the file is whole, in one process's layout
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == \
        {k: tuple(v.shape) for k, v in run["one_after"].items()}
    for where in (res["restored"], run["ranks"][0][mesh]["restored"]):
        for k, v in payload["params"].items():
            assert torch.equal(where["params"][k], v), k
        for key in ("mu", "nu"):
            assert len(where[key]) == len(payload["opt_state"][key])
            for a, b in zip(where[key], payload["opt_state"][key]):
                assert torch.equal(a, b), key
    for out in run["ranks"]:
        assert out[mesh]["restored_at"] == RESUME[mesh]
        _metrics_close(out[mesh]["resumed_step"], res["step"], TOL, f"{mesh} resumed at {RESUME[mesh]}")


def test_swin_bias_tables_sum_over_the_model_axis(run):
    """A replicated table read by heads: each model rank's gradient covers its
    heads' columns only, and after ``reduce_grads`` the whole gradient equals
    one process's."""
    one = run["swin_one"]
    assert one["reduced"]
    for r, out in enumerate(run["ranks"]):
        got = out["swin"]
        _metrics_close(got["metrics"], one["metrics"], TOL, "swin")
        for n, g in one["reduced"].items():
            _close(got["reduced"][n], g, TOL, n)
            local = got["local"][n]
            heads = g.shape[1] // 2
            mine = slice((r % 2) * heads, (r % 2 + 1) * heads)
            other = slice(((r + 1) % 2) * heads, ((r + 1) % 2 + 1) * heads)
            assert float(local[:, other].abs().max()) == 0.0, n
            assert float(local[:, mine].abs().max()) > 0.0, n
    for n, p in one["params"].items():
        _close(run["ranks"][0]["swin"]["params"][n], p, TOL, f"swin updated {n}")


def test_gqa_step_equals_one_process(run):
    one = run["gqa_one"]
    for out in run["ranks"]:
        _metrics_close(out["gqa"]["step"], one["step"], TOL, "gqa")
    for n, p in one["after"].items():
        _close(run["ranks"][0]["gqa"]["after"][n], p, TOL, f"gqa updated {n}")


@pytest.mark.parametrize("flow", list(EP_SP))
def test_ep_sp_step_equals_one_process(run, flow):
    """Losses with ``moe_aux``, grad norm, every updated parameter, and the
    router gradient that each model rank hands its update."""
    key = EP_SP[flow][0]
    one = run["ep_sp_one"][key]
    assert ("moe_aux" in one["step"]) == ("moe" in key)
    assert bool(one["routers"]) == ("moe" in key)
    for r, out in enumerate(run["ranks"]):
        o = out[flow]
        _metrics_close(o["step"], one["step"], TOL, flow)
        assert o["routers"].keys() == one["routers"].keys()
        for n, g in one["routers"].items():
            assert float(g.abs().max()) > 0, n
            _close(o["routers"][n], g, TOL, f"{flow} rank {r} router gradient {n}")
    after = run["ranks"][0][flow]["after"]
    assert after.keys() == one["after"].keys()
    for n, p in one["after"].items():
        _close(after[n], p, TOL, f"{flow} updated {n}")


@pytest.mark.parametrize("flow", list(EP_SP))
def test_ep_sp_step_equals_jax(run, jax_ref, jax_moe_ref, flow):
    ref = jax_moe_ref if "moe" in EP_SP[flow][0] else jax_ref
    _against_jax([(out[flow]["jax_step"], out[flow]["jax_after"]) for out in run["ranks"]], ref, flow)


@pytest.mark.parametrize("flow", list(EP_SP))
def test_ep_sp_split_on_every_rank(run, flow):
    """Every rank's step ran its experts split where the flow has MoE, and its
    fusion sequence split where the flow asks for it; one process neither."""
    key = EP_SP[flow][0]
    for out in run["ranks"]:
        ep, sp = out[flow]["counts"]
        assert (ep > 0, sp > 0) == ("moe" in key, "sp" in key), (flow, ep, sp)
    assert run["ep_sp_one"][key]["counts"] == (0, 0)


def test_ep_sp_fsdp_validation_equals_one_process(run):
    flow = EP_SP_RESUME[0]
    one = run["ep_sp_one"]["moe_sp"]["eval"]
    assert one["hyps"] and len({str(x["caption"]) for v in one["hyps"].values() for x in v}) > 1
    for out in run["ranks"]:
        got = out[flow]["eval"]
        assert got["ret"] == one["ret"]
        assert got["cap"] == one["cap"]
    got = run["ranks"][0][flow]["eval"]["hyps"]
    assert {k: sorted(v, key=lambda x: x["video_id"]) for k, v in got.items()} == \
        {k: sorted(v, key=lambda x: x["video_id"]) for k, v in one["hyps"].items()}


def test_ep_sp_fsdp_scst_rewards_and_alpha_equal(run):
    flow = EP_SP_RESUME[0]
    m = EP_SP[flow][1]
    _scst_equal([out[flow]["scst"] for out in run["ranks"]], run["ep_sp_one"]["moe_sp"]["scst"],
                [(r // m, WORLD // m) for r in range(WORLD)])


def test_ep_sp_fsdp_checkpoint_resumes_at_tp_and_in_one_process(run):
    flow, dst = EP_SP_RESUME
    res = run["ep_sp_one"]["resumed"]
    payload = res["payload"]
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == \
        {k: tuple(v.shape) for k, v in run["ep_sp_one"]["moe_sp"]["after"].items()}
    for where in (res["restored"], run["ranks"][0][flow]["restored"]):
        for k, v in payload["params"].items():
            assert torch.equal(where["params"][k], v), k
        for key in ("mu", "nu"):
            assert len(where[key]) == len(payload["opt_state"][key])
            for a, b in zip(where[key], payload["opt_state"][key]):
                assert torch.equal(a, b), key
    for out in run["ranks"]:
        _metrics_close(out[flow]["resumed_step"], res["step"], TOL, f"{flow} resumed at {dst}")


@pytest.mark.parametrize("flow", list(PP))
def test_pp_stack_ran_pipelined_on_every_rank(run, flow):
    m, s = PP[flow][:2]
    for r, out in enumerate(run["ranks"]):
        o = out[flow]
        assert o["grid"] == (r // (m * s), (r // s) % m, r % s, s)
        assert o["rows"] == (r // (m * s) * s + r % s, WORLD // m)  # the pipe folds into the batch
        assert o["applied"] > o.get("eval_applied", 0) == 0, flow
        assert (o["zero_split"] > 0) == (PP[flow][3] and not PP[flow][2]), flow


@pytest.mark.parametrize("flow", list(PP))
def test_pp_step_equals_one_process(run, flow):
    """The one process of the dense meshes: its config is the pipelined
    flows' without the pipeline knobs, which one process reads and ignores."""
    for out in run["ranks"]:
        _metrics_close(out[flow]["step"], run["one_step"], TOL, flow)
    after = run["ranks"][0][flow]["after"]
    assert after.keys() == run["one_after"].keys()
    for n, p in run["one_after"].items():
        _close(after[n], p, TOL, f"{flow} updated {n}")


@pytest.mark.parametrize("flow", list(PP))
def test_pp_step_equals_jax(run, jax_ref, flow):
    """Losses and grad norm (the updates are held to one port process)."""
    _against_jax([(out[flow]["jax_step"], None) for out in run["ranks"]], (jax_ref[0], None), flow)


def test_pp_validation_equals_one_process(run):
    flow = PP_RESUME[0]
    one = run["one_eval"]
    assert one["hyps"] and len({str(x["caption"]) for v in one["hyps"].values() for x in v}) > 1
    for out in run["ranks"]:
        got = out[flow]["eval"]
        assert got["ret"] == one["ret"]
        assert got["cap"] == one["cap"]
    got = run["ranks"][0][flow]["eval"]["hyps"]
    assert {k: sorted(v, key=lambda x: x["video_id"]) for k, v in got.items()} == \
        {k: sorted(v, key=lambda x: x["video_id"]) for k, v in one["hyps"].items()}


def test_pp_scst_rewards_and_alpha_equal(run):
    flow = PP_RESUME[0]
    _scst_equal([out[flow]["scst"] for out in run["ranks"]], run["one_scst"],
                [out[flow]["rows"] for out in run["ranks"]])


def test_pp_checkpoint_resumes_at_tp_and_in_one_process(run):
    flow, dst = PP_RESUME
    res = run["pp_one"]["resumed"]
    payload = res["payload"]
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == \
        {k: tuple(v.shape) for k, v in run["one_after"].items()}
    for where in (res["restored"], run["ranks"][0][flow]["restored"]):
        for k, v in payload["params"].items():
            assert torch.equal(where["params"][k], v), k
        for key in ("mu", "nu"):
            assert len(where[key]) == len(payload["opt_state"][key])
            for a, b in zip(where[key], payload["opt_state"][key]):
                assert torch.equal(a, b), key
    for out in run["ranks"]:
        _metrics_close(out[flow]["resumed_step"], res["step"], TOL, f"{flow} resumed at {dst}")
