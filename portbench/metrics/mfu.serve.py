"""Percent of the card's dense bf16 peak: the benchmark's operation count of
the captions completed in the window (flops.caption_request, real rows only)
over the window's seconds."""

from portbench.harness import BF16_FLOPS_PER_S


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["completed"] * ctx["request_flops"] / (ctx["window_s"] * ctx["chips"] * BF16_FLOPS_PER_S)
