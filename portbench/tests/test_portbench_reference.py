"""(e) The plain reference against ``valor_tpu_torch`` at the tiny configuration, fp32, on the CPU.

Both load the same tensors (``portbench/weights.py``); the tolerance is the
one ROADMAP holds the whole model to, 1e-4.  The training step covers the
three towers, the fusion encoder with cross-attention, the LayerNorms, both
losses of every group, every parameter's gradient and the AdamW update, with
the dropout and token masks of the same seed; the decode covers the device
filterbank, the encoders and every step's logits of a greedy caption.  (The
test imports both; the reference imports nothing of the program.)
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import generators, weights
from portbench.kinds import pretrain, serve
from portbench.reference.model import Numerics, ReferenceVALOR, mix
from portbench.tests.tiny import PRETRAIN, SERVE, TASK, TINY

TOL = dict(atol=1e-4, rtol=1e-4)


def _reference(cfg):
    ref = ReferenceVALOR(cfg, Numerics("fp32"))
    ref.load_state_dict(weights.make(cfg, 21, "cpu"), strict=True)
    return ref


def test_state_dict_names_and_shapes_match_the_program():
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.valor import VALORModel

    for cfg in (TINY, dict(TINY, use_task_prompt=True)):
        port = VALORModel(load_config(None, cfg).model, device="meta")
        ours = dict(weights.shapes(cfg)[0])
        assert {n: tuple(p.shape) for n, p in port.named_parameters()} == ours


def test_training_step_matches_the_program():
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.models.bridge import train_model
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, train_step

    mixp = dict(PRETRAIN, pool=1, prompt_contra=5, prompt_caption=6)
    batch = {k: torch.from_numpy(v) for k, v in generators.pretrain_pool(mixp, TINY, 9)[0].items()}
    full = load_config(None, TINY)
    model = train_model(full.model, weights.make(TINY, 21, "cpu"), "cpu")
    state = TrainState(model, build_optimizer(model, full.train))
    ref = _reference(TINY).train()
    seed = mix(full.train.seed, 0)
    parts = ref.pretrain_losses(batch, seed)
    names = [n for n, _ in ref.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(sum(parts.values()), [p for _, p in ref.named_parameters()],
                                                allow_unused=True)))
    metrics = train_step(state, batch, parse_task(TASK), full.train.seed)
    for k in ("contra_loss", "caption_loss"):
        torch.testing.assert_close(metrics[k], parts[k].detach(), **TOL)
    port_grads = dict(zip(state.optimizer.names, [m / (1 - state.optimizer.b1) for m in state.optimizer.mu]))
    scale = min(1.0, full.train.grad_norm / float(torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads.values() if g is not None]))))
    for n in names:
        want = torch.zeros_like(port_grads[n]) if grads[n] is None else grads[n] * scale
        torch.testing.assert_close(port_grads[n], want, **TOL, msg=n)


def test_three_steps_match_the_program_through_the_cell():
    """The cell's own comparison at the tiny size: the program's readings
    (losses, first gradients, changes after three steps) and the reference's."""
    from valor_tpu_torch.core.config import load_config

    full = load_config(None, TINY)
    pool = [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in generators.pretrain_pool(dict(PRETRAIN, pool=3), TINY, 4)]
    readings = pretrain.reference(torch, TINY, 21, pool, full, torch.device("cpu"))
    control = pretrain.reference(torch, TINY, 21, pool, full, torch.device("cpu"), numerics="fp8")
    assert readings["losses"][0]["total_loss"] > 0
    gaps = pretrain.compare(control, readings)
    assert max(gaps.values()) > 1e-3  # fp8 products move every reading off the fp32 reference


def test_decode_logits_match_the_program():
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.eval.generate import Generator, make_fusion_decoder
    from valor_tpu_torch.models.bridge import load_model

    model = load_model(load_config(None, TINY).model, weights.make(TINY, 21, "cpu"), "cpu")
    item = generators.serve_pool(dict(SERVE, pool=1), TINY, 3)[0]
    batch = {k: torch.from_numpy(v[None]) for k, v in item.items()}
    gen = Generator(model)
    seq = gen.generate(batch, ("tva",), max_len=SERVE["max_len"])["generated_sequences_tva"][0].numpy()
    ref = _reference(TINY).eval()
    ours = serve.reference_logits(ref, torch, item, seq, torch.device("cpu"))
    steps = ours.shape[0]
    with torch.no_grad():
        v, a = gen.encode(batch, ("tva",))
        decoder = make_fusion_decoder(model, None, v, a)
        width = SERVE["max_len"] + 2
        buf = torch.zeros((1, width), dtype=torch.long)
        buf[0, 0] = 101
        theirs = []
        for t in range(steps):
            tokens = buf.clone()
            tokens[0, t + 1] = 103
            mask = (torch.arange(width)[None] <= t + 1).float()
            theirs.append(decoder(tokens, mask)[0, t + 1])
            buf[0, t + 1] = int(seq[t])
    torch.testing.assert_close(ours, torch.stack(theirs), **TOL)
    assert int(np.argmax(ours[0].numpy())) == int(seq[0])
