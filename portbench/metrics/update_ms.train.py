"""Device milliseconds a step of the operations launched inside the program's
``train_step.update`` range, the optimizer (profiler trace)."""


def read(ctx):
    t = ctx.get("trace", {}).get("host")
    if ctx.get("kind") != "train" or not t or "train_step.update" not in t["by_range_s"]:
        return None
    return 1e3 * t["by_range_s"]["train_step.update"] / t["boundaries"]
