"""Kernels, causal attention: the least time of the window's causal
attention (4·H·D·S(S+1)/2 a layer over the peak, or its bytes) / the
device time of the `flash` kernel group, %."""


def read(ctx):
    f, busy = ctx.facts, ctx.group_s("flash")
    if f.get("kind") != "ppl" or busy <= 0:
        return None
    return 100.0 * f["flash_bound_s"] / busy
