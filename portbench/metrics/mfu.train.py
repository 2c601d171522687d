"""Percent of the card's dense bf16 peak: the benchmark's operation count of
the window's completed steps (flops.pretrain_step) over the window's seconds
times the cards."""

from portbench.harness import BF16_FLOPS_PER_S


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["steps"] * ctx["step_flops"] / (ctx["window_s"] * ctx["chips"] * BF16_FLOPS_PER_S)
