"""(d) The LayerNorm bytes that the hooks record, against the shapes written out by hand for one tiny step."""

from __future__ import annotations

import torch

from portbench import generators, kernels, weights
from portbench.kinds.pretrain import _ln_hooks
from portbench.tests.tiny import PRETRAIN, TINY


def test_hooks_record_every_layernorm_of_a_step():
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.models.bridge import train_model
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, train_step

    full = load_config(None, TINY)
    model = train_model(full.model, weights.make(TINY, 2, "cpu"), "cpu")
    state = TrainState(model, build_optimizer(model, full.train))
    record = {"on": True, "calls": []}
    hooks = _ln_hooks(torch, model, record)
    batch = {k: torch.from_numpy(v) for k, v in generators.pretrain_pool(dict(PRETRAIN, pool=1), TINY, 5)[0].items()}
    train_step(state, batch, parse_task(PRETRAIN["task"]), 50)
    for h in hooks:
        h.remove()

    b, f, c, n, w = 4, 2, 1, 12, 32  # batch, frames, clips, text slots, every width of the tiny model
    rows = ([b * f * 5] * (1 + 2 * 2 + 1)  # ViT: ln_pre, 2 blocks x (ln1, ln2), ln_post; 4 patches + CLS
            + [b * c * 3] * (2 * 2 + 1)  # AST: 2 blocks x 2, last; 2 patches + CLS
            + [b * n] * (2 * 2 + 1)  # CLIP text: 2 blocks x 2, ln_final
            + [b * n] * 3 * (1 + 2 * 3 + 1))  # fusion, 3 groups: embeddings, 2 layers x 3, the head's
    assert sorted(r for r, _, _, _, _ in record["calls"]) == sorted(rows)
    assert all(cols == w and xb == yb == 4 and grad for _, cols, xb, yb, grad in record["calls"])
    assert kernels.k1_fwd_bytes(record["calls"]) == sum(r * w * (4 + 4) + 2 * 4 * w for r in rows)
    assert kernels.k1_bwd_bytes(record["calls"]) == sum(r * w * (4 + 4 + 4) + 3 * 4 * w for r in rows)


def test_bytes_of_mixed_types():
    calls = [(100, 768, 2, 2, True), (10, 512, 4, 2, False)]
    assert kernels.k1_fwd_bytes(calls) == 100 * 768 * 4 + 8 * 768 + 10 * 512 * 6 + 8 * 512
    assert kernels.k1_bwd_bytes(calls) == 100 * 768 * 6 + 12 * 768
