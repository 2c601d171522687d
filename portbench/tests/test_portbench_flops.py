"""(c) The benchmark's operation count against ``torch.utils.flop_counter`` over the program's own work.

``torch.utils.flop_counter``'s formulas count every matrix product and
convolution that torch runs (2 m k n each, and the backward's products); a
dispatch mode applies them to every operation of one training step of the
program and of one greedy decode, at the tiny configuration on the CPU
(``FlopCounterMode`` itself tracks modules with backward hooks that
``torch.autograd.grad`` refuses).  The
benchmark's count (``portbench/flops.py``) is made from the shapes alone.
Where they differ, the test names why.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from portbench import flops, generators, weights
from portbench.tests.tiny import PRETRAIN, SERVE, TINY


class FlopCounterMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out

    def get_total_flops(self) -> int:
        return self.total


def _port_model(train: bool):
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import load_model, train_model

    full = load_config(None, TINY)
    w = weights.make(TINY, 11, "cpu")
    return full, (train_model if train else load_model)(full.model, w, "cpu")


def _program_extra(cfg: dict, batch: int, frames: int, clips: int, n_txt: int) -> int:
    """What the program computes beyond the model's equations, and one term it skips.

    * ``group_score_matrix`` runs the three token-weight MLPs (text, video,
      audio) once for each of the three contrastive groups, where the model
      needs them once: two more forwards of all three, and their backwards,
      but for the audio weights in ``tv`` and the video weights in ``ta``,
      which no loss reads, so autograd runs no backward for them;
    * the audio side of ``ta`` has one token a clip: the ``abv,bv->ab`` sum over
      it is a product with nothing to add, which einsum computes as an
      element-wise multiply, not a matrix product (2 B B a clip, forward and
      backward)."""
    from portbench.reference.model import TEXT, Shape

    embed = TEXT[Shape.of(cfg).clip][4]

    def mlp(tokens):
        return batch * (2 * tokens * embed * embed + 2 * tokens * embed)

    weights = mlp(n_txt) + mlp(frames) + mlp(clips)
    recompute = 2 * weights + 2 * (2 * weights) - 2 * (mlp(clips) + mlp(frames))
    return recompute - 3 * 2 * batch * batch * clips


def test_training_step_count_equals_flop_counter():
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, train_step

    full, model = _port_model(True)
    state = TrainState(model, build_optimizer(model, full.train))
    batch = {k: torch.from_numpy(v) for k, v in generators.pretrain_pool(dict(PRETRAIN, pool=1), TINY, 5)[0].items()}
    with FlopCounterMode() as counter:
        train_step(state, batch, parse_task(PRETRAIN["task"]), 50)
    shape = (PRETRAIN["batch"], PRETRAIN["frames"], PRETRAIN["clips"], PRETRAIN["n_txt"])
    ours = flops.pretrain_step(TINY, *shape)
    assert ours + _program_extra(TINY, *shape) == counter.get_total_flops()


def test_training_step_count_with_prompts_equals_flop_counter():
    from valor_tpu_torch.core.tasks import parse_task
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState, train_step

    full, model = _port_model(True)
    state = TrainState(model, build_optimizer(model, full.train))
    mix = dict(PRETRAIN, pool=1, prompt_contra=5, prompt_caption=6)
    batch = {k: torch.from_numpy(v) for k, v in generators.pretrain_pool(mix, TINY, 5)[0].items()}
    with FlopCounterMode() as counter:
        train_step(state, batch, parse_task(PRETRAIN["task"]), 50)
    shape = (mix["batch"], mix["frames"], mix["clips"], mix["n_txt"])
    ours = flops.pretrain_step(TINY, *shape, 5, 6)
    assert ours + _program_extra(TINY, *shape) == counter.get_total_flops()


def test_caption_count_equals_flop_counter_but_the_filterbank():
    """The decode's count leaves out the filterbank's two float64 products
    (frames x window by the DFT basis, then the power spectrum by the mel
    bank): preprocessing, not the model.  Everything else is equal."""
    from valor_tpu_torch.eval.generate import Generator

    _, model = _port_model(False)
    item = generators.serve_pool(dict(SERVE, pool=1), TINY, 3)[0]
    batch = {k: torch.from_numpy(v[None]) for k, v in item.items()}
    gen = Generator(model)
    with torch.no_grad(), FlopCounterMode() as counter:  # generate's own inference mode hides ops from the mode
        Generator.generate.__wrapped__(gen, batch, ("tva",), max_len=SERVE["max_len"])
    samples = generators.clip_span_samples(TINY["audio_target_length"])
    win, nfft = int(22050 * 0.025), 1024
    frames = 1 + (samples - win) // int(22050 * 0.010)
    fbank = SERVE["clips"] * frames * (2 * win * 2 * (nfft // 2 + 1) + 2 * (nfft // 2 + 1) * TINY["audio_melbins"])
    ours = flops.caption_request(TINY, SERVE["frames"], SERVE["clips"], SERVE["max_len"])
    assert ours + fbank == counter.get_total_flops()
