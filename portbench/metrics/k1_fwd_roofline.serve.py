"""Percent of K1-fwd's bytes bound: the bytes of every LayerNorm forward in the
traced stretch (kernels.k1_fwd_bytes over the shapes the hooks recorded) at
the HBM rate, over the device time of layernorm_fwd_kernel (profiler trace)."""

from portbench.kernels import k1_fwd_bytes, kernel_seconds, roofline_share


def read(ctx):
    t = ctx.get("trace", {}).get("device")
    if ctx.get("kind") != "serve" or not t:
        return None
    return roofline_share(k1_fwd_bytes(t["ln_calls"]), kernel_seconds(t["by_name_s"], "layernorm_fwd_kernel"))
