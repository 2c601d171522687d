"""SCST across processes: two gloo ranks of 4 rows on the CPU against one
process of 8 (``train/trainer.py:Trainer.scst_step``), and one process
against ``valor_tpu``'s ``scst_step``.

The tiny config in fp32 with the JAX package's initialised weights
(``tests/test_torch_caption.py:tiny_jax_params``), ``cap%tva%tv`` (two
caption groups, so two updates and two ``AdaptiveAlpha`` updates a step),
``AdaptiveAlpha`` of type 2 so that alpha moves; rank r holds the rows r, r + 2,
... of the global batch.  Both sides get the same greedy and sampled
rollouts (``_decode`` patched, as tests/test_torch_scst.py does), each rank
its rows.  Tolerances:

  * the rewards to 1e-12 and alpha exactly: every rank scores the gathered
    global batch with the same host Python as one process;
  * the losses, the gradients and the parameters after one update 1e-5 (two
    ranks against one process, fp32 sums in another order);
  * without patching, each rank's greedy and sampled rollouts equal one
    process's rows token for token (the uniforms are drawn at the global
    batch's shape, ``eval/generate.py``);
  * one process against the JAX package's ``scst_step`` on the same patched
    rollouts: rewards equal, losses and updated parameters 1e-4, the
    whole-model tolerance (tests/test_torch_scst.py says why);
  * ``cli.train --scst_finetuning true`` under two ranks: the losses and
    rewards of one process's run within 1e-5, alpha equal on both ranks.

All rank-side work runs in one two-rank launch.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_data import TINY_VOCAB
from valor_tpu_torch.parallel import mesh as P
from valor_tpu_torch.parallel.launch import run_local

WORLD = 2
LIMIT = 240
TOL = 1e-5
TOL_JAX = 1e-4
LR = 1e-4
TASK = "cap%tva%tv"
IDS = ["a", "b", "c", "d", "a", "d", "b", "c"]
STEPS = 2


def _rollouts():
    """Greedy and sampled rows of in-vocabulary ids (EOS 102 mid-row, a row without EOS)."""
    rng = np.random.RandomState(9)
    greedy = rng.randint(106, 118, size=(8, 6)).astype(np.int32)
    sample = rng.randint(106, 118, size=(8, 6)).astype(np.int32)
    greedy[::3, 3:] = 102
    sample[1::2, 4:] = 102
    sample[0] = [106, 107, 115, 108, 109, 110]  # "a cat sits on the mat": a high reward
    return greedy, sample


def _fake_decode(greedy, sample):
    """``_decode`` returning the given rows of this rank (all in one process)."""
    def decode(model, caption_type, max_len, beam_size, mode, prompt, v, a, generator):
        s = P.current_shard()
        rows = slice(None) if s is None else s.index
        seqs = (greedy if mode == "greedy" else sample)[rows]
        return torch.from_numpy(np.ascontiguousarray(seqs)), torch.zeros(seqs.shape)
    return decode


def _trainer(cfg, sd, ann, vocab, train_ids):
    from valor_tpu_torch.core.config import Config, TrainConfig
    from valor_tpu_torch.data.tokenizers.wordpiece import BertTokenizer
    from valor_tpu_torch.eval.scorer import AdaptiveAlpha, Scorer
    from valor_tpu_torch.models.bridge import train_model
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState
    from valor_tpu_torch.train.trainer import Trainer

    model = train_model(cfg, sd, "cpu")
    tcfg = TrainConfig(learning_rate=LR, num_train_steps=10, warmup_ratio=0.0)
    t = Trainer(Config(model=cfg, train=tcfg), TrainState(model, build_optimizer(model, tcfg)), [],
                scorer=Scorer(ann, train_ids, BertTokenizer(vocab)))
    t.alpha = AdaptiveAlpha(alpha_type=2, beta=0.9)
    return t


def scst_steps(cfg, sd, ann, vocab, batch, ids, patch):
    """``STEPS`` SCST steps on ``batch`` (this rank's rows inside a group):
    per step the metrics; per update the advantages and the gradients it
    took; the parameters after the first update; alpha's state; and, in an
    unpatched run, every rollout's rows."""
    import valor_tpu_torch.train.trainer as T
    from valor_tpu_torch.core.tasks import parse_task

    trainer = _trainer(cfg, sd, ann, vocab, sorted(set(IDS)))
    out = {"metrics": [], "rewards": [], "grads": [], "params_1": None, "rollouts": []}
    update0, decode0, opt = T.scst_update, T._decode, trainer.state.optimizer
    upd0 = opt.update

    def update(*a, **kw):
        out["rewards"].append(a[3].detach().clone())
        m = update0(*a, **kw)
        if out["params_1"] is None:
            out["params_1"] = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()}
        return m

    def opt_update(grads):
        out["grads"].append([g.detach().clone() for g in grads])
        return upd0(grads)

    def decode(*a):
        seqs, logps = decode0(*a)
        out["rollouts"].append((a[4], seqs.clone()))
        return seqs, logps

    T.scst_update, opt.update = update, opt_update
    T._decode = _fake_decode(*patch) if patch is not None else decode
    try:
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        for _ in range(STEPS):
            out["metrics"].append({k: float(v) for k, v in trainer.scst_step(tb, ids, parse_task(TASK)).items()})
    finally:
        T.scst_update, T._decode = update0, decode0
    a = trainer.alpha
    out["alpha"] = (a.value(), a.idx, a.sample_total, a.greedy_total)
    out["params_end"] = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()}
    return out


def _rank(cfg, sd, ann, vocab, shards, patch, cli, env):
    from valor_tpu_torch.cli.train import main

    os.environ.update(env)
    P.init_data_parallel("gloo", "cpu")
    r = P.rank()
    ids = IDS[r::WORLD]
    out = {"patched": scst_steps(cfg, sd, ann, vocab, shards[r], ids, patch),
           "unpatched": scst_steps(cfg, sd, ann, vocab, shards[r], ids, None)}
    trainer = main(["--config", cli, "--device", "cpu", "--scst_finetuning", "true"])
    out["cli"] = {"history": [h[2] for h in trainer.history], "alpha": trainer.alpha.value()}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from tests.test_torch_caption import tiny_jax_params
    from tests.test_torch_ddp_cli import TINY, _config, _env, _flow
    from tests.test_torch_models import _np, tiny_batch, torch_config
    from valor_tpu_torch.data.synthetic import write_caption_dataset
    from valor_tpu_torch.models.bridge import params_from_jax

    root = tmp_path_factory.mktemp("ddp_scst")
    (root / "vocab.txt").write_text("\n".join(TINY_VOCAB))
    ann = {"a": ["A cat sits on the mat.", "the cat sits", "a cat, on a mat!"],
           "b": ["The dog runs", "a dog runs on the mat"], "c": "the mat",
           "d": ["a dog sits on the cat", "dogs run", "the cat runs on the dog", "a mat"]}
    (root / "ann.json").write_text(json.dumps(ann))
    jcfg, params = tiny_jax_params()
    cfg = torch_config(jcfg)
    sd = params_from_jax(_np(params))
    batch = tiny_batch(seed=5, b=8)
    shards = [{k: v[r::WORLD] for k, v in batch.items()} for r in range(WORLD)]
    patch = _rollouts()
    paths = (str(root / "ann.json"), str(root / "vocab.txt"))
    # cli.train: SCST on a caption flow that draws nothing at random on the host
    data = write_caption_dataset(str(root / "cap"), n_train=8, n_val=2, captions_per_id=3, n_frames=2,
                                 frame_size=(64, 48), wav_seconds=1.0, workers=2)
    cli = _config({"ret": data}, root / "config.json", str(root / "cli_two"), [],
                  train=[_flow(data, "train", "cap%tv", 4)], num_train_steps=2, max_generation_len=4)
    env = _env({"ret": data})
    ranks = run_local(_rank, WORLD, cfg, sd, *paths, shards, patch, cli, env, timeout=LIMIT)
    one = {"patched": scst_steps(cfg, sd, *paths, batch, IDS, patch),
           "unpatched": scst_steps(cfg, sd, *paths, batch, IDS, None)}
    return {"jcfg": jcfg, "params": params, "batch": batch, "patch": patch, "paths": paths, "ranks": ranks,
            "one": one, "cli": cli, "env": env, "root": root, "tiny": TINY}


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol, err_msg=what)


def test_rewards_and_alpha_of_two_ranks_are_one_process_s(run):
    one = run["one"]["patched"]
    assert len(one["rewards"]) == STEPS * 2
    assert any(float(r.abs().max()) > 0.1 for r in one["rewards"])  # the patched rows earn rewards
    assert one["alpha"][0] != 1.0  # type 2 moved it
    for r, out in enumerate(run["ranks"]):
        got = out["patched"]
        assert got["alpha"] == one["alpha"]
        for mine, whole in zip(got["rewards"], one["rewards"]):
            _close(mine, whole[r::WORLD], 1e-12, "advantage")
        for m, w in zip(got["metrics"], one["metrics"]):
            assert m.keys() == w.keys()
            for k in w:
                if k.startswith("scst_reward"):
                    _close(m[k], w[k], 1e-12, k)


def test_losses_gradients_and_update_of_two_ranks(run):
    one = run["one"]["patched"]
    for out in run["ranks"]:
        got = out["patched"]
        for m, w in zip(got["metrics"], one["metrics"]):
            for k in w:
                _close(m[k], w[k], TOL, k)
        assert len(got["grads"]) == len(one["grads"]) == STEPS * 2
        for gs, ws in zip(got["grads"], one["grads"]):
            for g, w in zip(gs, ws):
                _close(g, w, TOL, "gradient")
        for n, p in one["params_1"].items():
            _close(got["params_1"][n], p, TOL, f"updated {n}")
    assert any(float(g.abs().max()) > 0 for g in one["grads"][0])


def test_sampled_rollouts_of_two_ranks_are_one_process_s(run):
    """Unpatched: each rank decodes its rows and samples what one process
    samples in them, token for token."""
    one = run["one"]["unpatched"]["rollouts"]
    modes = [m for m, _ in one]
    assert modes == ["greedy", "sample"] * (2 * STEPS)
    assert len({tuple(s.flatten().tolist()) for m, s in one if m == "sample"}) > 1
    for r, out in enumerate(run["ranks"]):
        got = out["unpatched"]["rollouts"]
        assert [m for m, _ in got] == modes
        for (_, mine), (_, whole) in zip(got, one):
            assert torch.equal(mine, whole[r::WORLD])


def test_one_process_matches_jax_scst_step(run, monkeypatch):
    from tests.test_torch_scst import _patch_rollouts
    from tests.test_torch_models import _np
    from valor_tpu.core.config import Config as JConfig
    from valor_tpu.core.config import TrainConfig as JTrainConfig
    from valor_tpu.core.tasks import parse_task
    from valor_tpu.data.tokenizers.wordpiece import BertTokenizer as JTok
    from valor_tpu.eval.scorer import AdaptiveAlpha as JAlpha
    from valor_tpu.eval.scorer import Scorer as JScorer
    from valor_tpu.models.valor import VALORModel as JaxVALOR
    from valor_tpu.train.optimizer import build_optimizer as jbuild
    from valor_tpu.train.step import TrainState as JState
    from valor_tpu.train.trainer import Trainer as JTrainer
    from valor_tpu_torch.models.bridge import params_from_jax

    greedy, sample = run["patch"]
    _patch_rollouts(monkeypatch, greedy, sample)  # the JAX decode (the port's is unused here)
    ann, vocab = run["paths"]
    kw = dict(learning_rate=LR, num_train_steps=10, warmup_ratio=0.0)
    jm, params = JaxVALOR(run["jcfg"]), run["params"]
    tx = jbuild(params, JTrainConfig(**kw))
    jt = JTrainer(JConfig(model=run["jcfg"], train=JTrainConfig(**kw)), jm, tx, JState.create(params, tx), [],
                  scorer=JScorer(ann, sorted(set(IDS)), JTok(vocab)))
    jt.alpha = JAlpha(alpha_type=2, beta=0.9)
    want = [jt.scst_step(dict(run["batch"]), IDS, parse_task(TASK)) for _ in range(STEPS)]
    one = run["one"]["patched"]
    for got, w in zip(one["metrics"], want):
        for k, v in w.items():
            if k.startswith("scst_reward"):
                assert got[k] == np.float32(v), k
            else:
                _close(got[k], v, TOL_JAX, k)
    assert one["alpha"][:2] == (jt.alpha.value(), jt.alpha.idx)
    assert int(jt.state.step) == STEPS * 2
    ref = params_from_jax(_np(jt.state.params))
    for n, p in one["params_end"].items():
        np.testing.assert_allclose(p.numpy(), ref[n].numpy(), rtol=0, atol=TOL_JAX, err_msg=n)


def test_cli_train_scst_under_two_ranks(run, monkeypatch):
    import sys

    from valor_tpu_torch.cli.train import main

    for k, v in run["env"].items():
        monkeypatch.setenv(k, v)
    monkeypatch.delitem(sys.modules, "tensorboardX", raising=False)
    one = main(["--config", run["cli"], "--device", "cpu", "--scst_finetuning", "true",
                "--output_dir", str(run["root"] / "cli_one")])
    want = [h[2] for h in one.history]
    assert len(want) == 2 and set(want[0]) == {"scst_reward_tv", "caption_loss_tv"}
    for out in run["ranks"]:
        assert out["cli"]["alpha"] == run["ranks"][0]["cli"]["alpha"] == one.alpha.value()
        for got, w in zip(out["cli"]["history"], want):
            for k in w:
                _close(got[k], w[k], TOL, f"cli.train {k}")
    assert os.path.isdir(run["root"] / "cli_two" / "ckpt" / "step_2")
