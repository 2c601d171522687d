"""A pretraining cell: ``Trainer.run`` -> ``train_step`` on batches held in memory.

Set-up builds one training state (the program's ``VALORModel`` holding the
benchmark's weights, its ``build_optimizer``) and one ``Trainer`` over an
iterator that cycles the mix's pool of pinned batches through the trainer's
own ``DevicePrefetcher``.  That one ``Trainer.run`` call drives everything:

  1. steps 1-3 on pool batches 0-2 (rows that all differ): the check's
     readings, taken by the step hook: each step's losses, the first
     moment after step 1 (the optimizer's input gradient, times 1 - b1) and
     each parameter's change after step 3, as per-leaf norms;
  2. ``warmup_steps`` more steps;
  3. the window: from a synchronise after the last warm-up step to a
     synchronise after the step in which ``seconds`` have passed.
     ``train_samples_per_s`` is the window's samples over its seconds.

With ``trace`` the steps after the window are traced: a step thrown away,
then two stretches of ``trace_steps`` steps (``tracing.Stretches``), with
forward hooks on the program's LayerNorm modules, put on at the window's
close, that record each call's shape over the first; the per-layer metrics
read them.  Nothing of the trace runs before the window closes.  Once the window
has closed and the peak memory is read, the program is freed and the
reference (fp32, TF32 off, layers checkpointed) makes the same three steps
from the same weights, batches and seeds.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Any, Dict, List

from portbench import flops, generators, harness, tracing, weights

CHECK_STEPS = 3


def _port(torch, prog: dict, seed: int, device):
    from valor_tpu_torch.core.config import load_config
    from valor_tpu_torch.models.bridge import train_model
    from valor_tpu_torch.train.optimizer import build_optimizer
    from valor_tpu_torch.train.step import TrainState

    full = load_config(None, prog)
    w = weights.make(prog, seed, device)
    model = train_model(full.model, w, device)
    p0 = {n: harness.pin(t.to("cpu")) for n, t in w.items()}
    del w
    opt = build_optimizer(model, full.train, full.model.frozen_vision, full.model.frozen_multimodal)
    return full, TrainState(model, opt), p0


def _ln_hooks(torch, model, record: Dict[str, Any]) -> list:
    from valor_tpu_torch.ops.layers import LayerNorm

    def hook(mod, inputs, output):
        if record["on"]:
            x = inputs[0]
            record["calls"].append((x.numel() // x.shape[-1], x.shape[-1], x.element_size(),
                                    output.element_size(), bool(output.requires_grad)))

    return [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, LayerNorm)]


def run(s: Dict[str, Any], seed: int, seconds: float, trace: bool, t_start: float) -> Dict[str, Any]:
    torch = harness.require_cuda(s["cell"]["chips"])
    from valor_tpu_torch.train.step import RANGES
    from valor_tpu_torch.train.trainer import Trainer

    traffic, cfg = s["traffic"], s["config"]
    prog = harness.program_config(cfg)
    device = harness.device(torch)
    full, state, p0 = _port(torch, prog, seed, device)
    pool = [{k: harness.pin(torch.from_numpy(v)) for k, v in b.items()}
            for b in generators.pretrain_pool(traffic, prog, seed)]
    task, batch = traffic["task"], traffic["batch"]
    opt = state.optimizer
    live = [opt.names[i] for i in opt.live]
    warm = traffic["warmup_steps"]
    k0 = CHECK_STEPS + warm  # the step after which the window opens
    box: Dict[str, Any] = {"stop": False, "losses": [], "window": None, "window_end": None, "steps": 0}
    ln = {"on": False, "calls": []}
    hooks: list = []
    stretches = tracing.Stretches(torch, length=traffic["trace_steps"]) if trace else None

    def batches():
        i = 0
        while not box["stop"]:
            yield task, pool[i % len(pool)]
            i += 1

    def hook(micro: int, task_name: str, metrics: Dict[str, Any]) -> None:
        if micro <= CHECK_STEPS:
            box["losses"].append({k: metrics[k] for k in ("contra_loss", "caption_loss", "total_loss")})
        if micro == 1:
            box["grad"] = torch.stack(torch._foreach_norm(opt.mu)) / (1.0 - opt.b1)
        if micro == CHECK_STEPS:
            box["update"] = torch.stack([torch.linalg.vector_norm(opt.params[i] - p0[opt.names[i]].to(device))
                                         for i in opt.live])
        if micro == k0:
            harness.sync(torch, device)
            box["window"] = time.perf_counter()
            box["setup_s"] = time.monotonic() - t_start
        elif micro > k0 and box["window_end"] is None:
            box["steps"] += 1
            if time.perf_counter() - box["window"] >= seconds:
                harness.sync(torch, device)
                box["window_end"] = time.perf_counter()
                box["stop"] = not trace
        if trace and box["window_end"] is not None and not box["stop"]:
            if not stretches.armed:  # the traced stretches follow the window, the hooks with them
                stretches.armed = True
                hooks.extend(_ln_hooks(torch, state.model, ln))
            stretches.advance()
            ln["on"] = stretches.active and stretches.current[0] == "device"
            box["stop"] = stretches.finished

    trainer = Trainer(full, state, batches(), step_hook=hook)
    trainer.run()
    harness.sync(torch, device)
    window_s = box["window_end"] - box["window"]
    if trace:
        stretches.finish()
    peak = harness.peak_bytes(torch, device)
    for h in hooks:
        h.remove()
    steps = box["steps"]
    failed = sum(1 for micro, _, vals in trainer.history  # window steps whose loss is not a number
                 if k0 < micro <= k0 + steps and not math.isfinite(vals.get("total_loss", math.nan)))
    program = {
        "losses": [{k: float(v) for k, v in d.items()} for d in box["losses"]],
        "grad": dict(zip(live, box["grad"].tolist())),
        "update": dict(zip(live, box["update"].tolist())),
    }
    metrics_ctx: Dict[str, Any] = {
        "window_s": window_s, "steps": steps, "samples": steps * batch, "chips": s["cell"]["chips"],
        "setup_s": box["setup_s"],
        "step_flops": flops.pretrain_step(prog, batch, traffic["frames"], traffic["clips"], traffic["n_txt"],
                                          traffic.get("prompt_contra", 0), traffic.get("prompt_caption", 0)),
        "kind": "train",
    }
    trace_summary = None
    if trace:
        metrics_ctx["trace"] = tracing.reduce_stretches(stretches, RANGES, ln["calls"])
        trace_summary = {k: metrics_ctx["trace"]["device"][k] for k in ("busy_s", "window_s")}
        harness.note(f"traced run: {steps * batch / window_s!r} samples/s, setup {box['setup_s']!r} s; "
                     f"trace {metrics_ctx['trace']['diagnostics']}")
    del trainer, state, opt, hooks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(torch, prog, seed, pool[:CHECK_STEPS], full, device)
    checks = compare(program, ref)
    harness.note(f"readings {checks}; worst leaves {worst_leaves(program, ref)}")
    judged = harness.judge(checks, s["limits"]["limits"])
    entries = s["per_layer"] if trace else s["end_to_end"]
    out = {
        "correct": harness.passed(judged),
        "attempted": steps,
        "failed": failed,
        "metrics": harness.read_metrics(entries, metrics_ctx),
        "device": harness.device_info(torch, s["cell"]["chips"], peak, trace_summary),
        "checks": judged,
    }
    if trace:
        out["breakdown"] = metrics_ctx["trace"]["breakdown"]
    return out


def reference(torch, prog: dict, seed: int, batches: List[Dict[str, Any]], full, device,
              numerics: str = "fp32") -> Dict[str, Any]:
    """The reference's readings of the check's three steps."""
    from portbench.reference.adamw import AdamW, group
    from portbench.reference.model import LayerNorm, Numerics, ReferenceVALOR, mix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = ReferenceVALOR(prog, Numerics(numerics), remat=True)
    model = model.to_empty(device=device)
    w = weights.make(prog, seed, device)
    model.load_state_dict(w, strict=True)
    model.train()
    named = dict(model.named_parameters())
    ln_params = {f"{m}.{p}" for m, mod in model.named_modules() if isinstance(mod, LayerNorm)
                 for p, _ in mod.named_parameters(recurse=False)}
    train = dict(prog, num_train_steps=full.train.num_train_steps, clip_lr=full.train.clip_lr,
                 clip_lr_text=full.train.clip_lr_text)
    opt = AdamW(named, {n: group(n, n in ln_params) for n in named}, train)
    losses, grad = [], None
    for k, host in enumerate(batches):
        batch = {key: v.to(device) for key, v in host.items()}
        parts = model.pretrain_losses(batch, mix(full.train.seed, k))
        total = sum(parts.values())
        grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(named.items(), grads)}
        clipped = opt.step(grads)
        if k == 0:
            grad = {n: float(v) for n, v in zip(named, torch.stack(
                [torch.linalg.vector_norm(clipped[n]) for n in named]).tolist())}
        losses.append({k: float(v.detach()) for k, v in dict(parts, total_loss=total).items()})
        del grads, clipped, parts, total
    with torch.no_grad():
        update = {n: float(torch.linalg.vector_norm(named[n] - w[n])) for n in named}
    del model, opt, w, named
    gc.collect()
    return {"losses": losses, "grad": grad, "update": update}


def compare(program: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The check's numbers (``limits/<workload>.json`` names those a cell compares):

    * ``loss_gap``: the largest relative gap of a loss (contrastive, caption)
      over the three steps; ``contra_gap``, ``caption_gap``: each loss's;
    * ``grad_gap``: the worst leaf's gap between the two norms of the first
      step's clipped gradient, over the reference's norm of that leaf or of the
      median leaf, whichever is larger; ``grad_gap_median``: the median leaf's
      gap, so measured;
    * ``update_gap``, ``update_gap_median``: the same for each parameter's
      change over the three steps, leaving out leaves whose reference gradient
      is under a thousandth of the median leaf's (nought but rounding: a key's
      bias under softmax).
    """
    gaps = {k: max(abs(p[k] - r[k]) / abs(r[k]) for p, r in zip(program["losses"], ref["losses"]))
            for k in ("contra_loss", "caption_loss")}
    names = list(program["grad"])
    med_g = statistics.median(ref["grad"][n] for n in names)
    grad = [abs(program["grad"][n] - ref["grad"][n]) / max(ref["grad"][n], med_g) for n in names]
    moved = [n for n in names if ref["grad"][n] >= 1e-3 * med_g]
    med_u = statistics.median(ref["update"][n] for n in moved)
    update = [abs(program["update"][n] - ref["update"][n]) / max(ref["update"][n], med_u) for n in moved]
    return {"loss_gap": max(gaps.values()), "contra_gap": gaps["contra_loss"], "caption_gap": gaps["caption_loss"],
            "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "update_gap": max(update), "update_gap_median": statistics.median(update)}


def worst_leaves(program: Dict[str, Any], ref: Dict[str, Any], k: int = 4) -> Dict[str, list]:
    """The ``k`` leaves with the widest gaps of each per-leaf reading, with both norms."""
    out = {}
    for key in ("grad", "update"):
        names = list(program[key])
        med = statistics.median(ref[key][n] for n in names)
        gaps = sorted(names, key=lambda n: -abs(program[key][n] - ref[key][n]) / max(ref[key][n], med))[:k]
        out[key] = [[n, program[key][n], ref[key][n]] for n in gaps] + [["median", med]]
    return out
