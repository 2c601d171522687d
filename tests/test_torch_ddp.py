"""Data-parallel training steps of the port (two gloo ranks on the CPU) against
``valor_tpu`` on the global batch (``tests/test_torch_ddp_steps.py``: against
the port's one process, and resume).

The tiny config in fp32; ranks run in processes of their own
(``parallel/launch.py:run_local``, which kills them past its time limit).
Each rank holds the strided rows of a global batch of 8 (rank r rows r, r + 2,
..., as the loaders' shards give them).  Dropout off and ``caption_type="lm"`` (``jax.random`` cannot be matched):
``pt``, ``ret``, ``cap``, ``qa`` with a different number of answers a question
(so the ranks hold 6 and 9 answer rows), ``tile_index`` and
``answer_weights``, and the MoE config's ``moe_aux``; the losses (the mean over
ranks) and every all-reduced gradient within 1e-4, the whole-model tolerance
of the port's tests.
"""

import numpy as np
import pytest
import torch

from valor_tpu_torch.core.config import TrainConfig
from valor_tpu_torch.core.tasks import parse_task as tparse
from valor_tpu_torch.models.bridge import init_params, train_model
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.launch import run_local
from valor_tpu_torch.train.optimizer import build_optimizer
from valor_tpu_torch.train.step import losses_and_grads

WORLD = 2
LIMIT = 180  # seconds a two-rank call may take
SEED = 5  # the step's random streams
TOL_JAX = 1e-4
TOL_ONE = 1e-5
PT_TASK = "pt_contra%tva%tv%ta_caption%tva%tv%ta"
MOE_TASK = "pt_contra%tva_caption%tva%tv"
AUX_W = 0.01
UPDATE = dict(learning_rate=1e-3, clip_lr=1e-3, clip_lr_text=1e-3, num_train_steps=10, warmup_ratio=0.0,
              weight_decay=0.01, grad_norm=0.5)
ANSWERS = [1, 3, 2, 1, 2, 2, 1, 3]  # answer rows a question: rank 0 holds 6, rank 1 holds 9


def _batch(seed, b=8, n_frames=2, n_clips=1, res=32, mel=16, alen=32):
    rng = np.random.RandomState(seed)
    txt = rng.randint(106, 512, size=(b, 8)).astype(np.int32)
    txt[:, 0], txt[:, -2], txt[:, -1] = 101, 102, 0
    txt[1, 4:] = 0
    return {"bert_tokens": txt, "clip_tokens": txt,
            "video_pixels": rng.randn(b, n_frames, res, res, 3).astype(np.float32),
            "audio_spectrograms": rng.randn(b, n_clips, mel, alen).astype(np.float32)}


def _qa_batch(seed, q=8):
    """A global QA training batch: ``ANSWERS`` tiled answer rows a question."""
    rng = np.random.RandomState(seed)
    tile = np.repeat(np.arange(q), ANSWERS).astype(np.int32)
    ans = rng.randint(106, 512, size=(len(tile), 7)).astype(np.int32)
    ans[:, 0], ans[:, 3], ans[:, 4:] = 101, 102, 0
    qs = rng.randint(106, 512, size=(len(tile), 6)).astype(np.int32)
    qs[:, 0], qs[:, -1] = 101, 102
    media = _batch(seed + 1, b=q)
    return {"bert_tokens": ans, "question_prompt": qs, "tile_index": tile,
            "answer_weights": rng.uniform(0.2, 1.0, len(tile)).astype(np.float32),
            "video_pixels": media["video_pixels"], "audio_spectrograms": media["audio_spectrograms"]}


def _shards(batch):
    """Each rank's rows: the strided media rows and, for QA, the answer rows
    of its questions with ``tile_index`` local to its rows."""
    if "tile_index" not in batch:
        return [{k: v[r::WORLD] for k, v in batch.items()} for r in range(WORLD)]
    out = []
    for r in range(WORLD):
        rows = batch["tile_index"] % WORLD == r
        shard = {k: batch[k][r::WORLD] for k in ("video_pixels", "audio_spectrograms")}
        shard.update({k: batch[k][rows] for k in ("bert_tokens", "question_prompt", "answer_weights")})
        shard["tile_index"] = (batch["tile_index"][rows] // WORLD).astype(np.int32)
        out.append(shard)
    return out


def _one_process_qa(shards):
    """The one-process batch of the ranks' QA shards: media rows interleaved,
    answer rows in rank order, ``tile_index`` to the global media row."""
    media = {k: np.stack([s[k] for s in shards], 1).reshape((-1,) + shards[0][k].shape[1:])
             for k in ("video_pixels", "audio_spectrograms")}
    media.update({k: np.concatenate([s[k] for s in shards]) for k in ("bert_tokens", "question_prompt",
                                                                      "answer_weights")})
    media["tile_index"] = np.concatenate([s["tile_index"] * WORLD + r for r, s in enumerate(shards)]).astype(np.int32)
    return media


def _step(cfg, batch, task, aux=0.0, update=False):
    """Losses, gradients (by parameter name) and, with ``update``, the
    parameters after one update, of the port's step on ``batch``."""
    model = train_model(cfg, init_params(cfg, 0, "cpu"), "cpu")
    metrics, grads = losses_and_grads(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tparse(task),
                                      SEED, moe_aux_weight=aux)
    names = [n for n, _ in model.named_parameters()]
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": dict(zip(names, grads))}
    if update:
        build_optimizer(model, TrainConfig(**UPDATE)).update(grads)
        out["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


def _rank_steps(cases):
    P.init_data_parallel("gloo", "cpu")
    return {name: _step(c["cfg"], c["shards"][P.rank()], c["task"], c.get("aux", 0.0), c.get("update", False))
            for name, c in cases.items()}


def _cfg(**kw):
    from tests.conftest import tiny_model_config
    from tests.test_torch_models import torch_config

    return torch_config(tiny_model_config(**kw))


JAX_CASES = {  # name: (config keys, task, batch)
    "pt": (dict(dropout=0.0, caption_type="lm"), PT_TASK, lambda: _batch(2)),
    "ret": (dict(dropout=0.0, caption_type="lm"), "ret%tva%tv", lambda: _batch(3)),
    "cap": (dict(dropout=0.0, caption_type="lm"), "cap%tva%tv", lambda: _batch(4)),
    "qa": (dict(dropout=0.0, caption_type="lm"), "qa%tva", lambda: _qa_batch(5)),
    "moe": (dict(dropout=0.0, caption_type="lm", fusion_moe_experts=4, fusion_moe_every=2), MOE_TASK,
            lambda: _batch(6)),
}


def make_cases(table, update=False):
    out = {}
    for name, (kw, task, make) in table.items():
        batch = make()
        out[name] = {"cfg": _cfg(**kw), "kw": kw, "task": task, "batch": batch, "shards": _shards(batch),
                     "aux": AUX_W if name == "moe" else 0.0, "update": update}
    return out


def run_cases(cases):
    """Every case's step on each of two ranks."""
    send = {k: {f: c[f] for f in ("cfg", "task", "shards", "aux", "update")} for k, c in cases.items()}
    return run_local(_rank_steps, WORLD, send, timeout=LIMIT)


@pytest.fixture(scope="module")
def cases():
    return make_cases(JAX_CASES)


@pytest.fixture(scope="module")
def ranks(cases):
    return run_cases(cases)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _jax_step(kw, task, batch, aux):
    """The JAX step's losses and gradients (``valor_tpu/train/step.py:_apply_losses``)
    on the global batch, with the port's seeded weights."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_models import _np, seeded_models
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.train.step import _apply_losses
    from valor_tpu_torch.models.bridge import params_from_jax

    jm, params, _ = seeded_models(**kw)
    spec = parse_task(task)

    def loss(p):
        losses = _apply_losses(jm, p, {k: jnp.asarray(v) for k, v in batch.items()}, spec, {}, aux)
        return sum(jnp.asarray(v, jnp.float32) for v in losses.values()), losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(total), {k: float(v) for k, v in losses.items()}, params_from_jax(_np(grads))


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_two_ranks_equal_jax_on_the_global_batch(name, cases, ranks):
    c = cases[name]
    total, losses, grads = _jax_step(c["kw"], c["task"], c["batch"], c["aux"])
    for out in ranks:
        got = out[name]
        assert set(got["metrics"]) == set(losses) | {"total_loss"}
        _close(got["metrics"]["total_loss"], total, TOL_JAX, f"{name} total_loss")
        for k, v in losses.items():
            _close(got["metrics"][k], v, TOL_JAX, f"{name} {k}")
        assert set(got["grads"]) == set(grads)
        for n, g in grads.items():
            _close(got["grads"][n], g, TOL_JAX, f"{name} grad {n}")
    if name == "moe":
        assert ranks[0]["moe"]["grads"]["multimodal_encoder.layer_1.moe_mlp.router"].abs().sum() > 0


