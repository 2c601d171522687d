"""Percent of K1-bwd's bytes bound: the bytes of every LayerNorm backward in the
traced steps (kernels.k1_bwd_bytes) at the HBM rate, over the device time of
``layernorm_bwd_kernel`` (profiler trace)."""

from portbench.kernels import k1_bwd_bytes, kernel_seconds, roofline_share


def read(ctx):
    t = ctx.get("trace", {}).get("device")
    if ctx.get("kind") != "train" or not t:
        return None
    return roofline_share(k1_bwd_bytes(t["ln_calls"]), kernel_seconds(t["by_name_s"], "layernorm_bwd_kernel"))
