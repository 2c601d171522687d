"""Samples of every optimizer step completed in the window, over the window's seconds (host clock)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("window_s"):
        return None
    return ctx["samples"] / ctx["window_s"]
