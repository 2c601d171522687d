"""Device milliseconds a step of the operations launched inside the program's
``train_step.forward`` and ``train_step.backward`` ranges, in the stretch that
traces the host too (profiler trace)."""


def read(ctx):
    t = ctx.get("trace", {}).get("host")
    if ctx.get("kind") != "train" or not t:
        return None
    r = t["by_range_s"]
    if "train_step.forward" not in r or "train_step.backward" not in r:
        return None
    return 1e3 * (r["train_step.forward"] + r["train_step.backward"]) / t["boundaries"]
