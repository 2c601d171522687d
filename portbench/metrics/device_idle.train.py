"""Percent of the traced window with no operation on the card: one minus the
union of the device operations' intervals over the stretch from the first
one's start to the last one's end, in the stretch that traces the device
alone (profiler trace)."""


def read(ctx):
    t = ctx.get("trace", {}).get("device")
    if ctx.get("kind") != "train" or not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
