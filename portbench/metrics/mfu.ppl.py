"""Whole step: the useful operations of the window's forwards (linears at
top-k, router, causal attention, head) / (window wall x 989 TFLOP/s), %."""

from portbench.work import PEAK_FLOPS


def read(ctx):
    f = ctx.facts
    if f.get("kind") != "ppl" or not f["wall_s"]:
        return None
    return 100.0 * f["step_flops"] / (f["wall_s"] * PEAK_FLOPS)
