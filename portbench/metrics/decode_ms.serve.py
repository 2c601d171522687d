"""Device milliseconds a launched batch: the device operations launched inside
the benchmark's ``engine.launch`` spans of the stretch that traces the host
too, over the batches launched there (profiler trace)."""


def read(ctx):
    t = ctx.get("trace", {}).get("host")
    if ctx.get("kind") != "serve" or not t or not t["boundaries"] or "engine.launch" not in t["by_range_s"]:
        return None
    return 1e3 * t["by_range_s"]["engine.launch"] / t["boundaries"]
