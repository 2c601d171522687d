"""95th percentile of every request due in the window, each from when it was
due to when its caption reached the client thread; a request that failed,
was shed or missed the drain deadline counts at the deadline (host clock)."""

from portbench.harness import percentile


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("latency_s"):
        return None
    return 1e3 * percentile(ctx["latency_s"], 0.95)
