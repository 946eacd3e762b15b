"""Kernels, quantized linears: the least time the window's linears need
for their useful work (`work.linear_bound_s`: a PPL window's tokens; a
decode step's live tokens, every weight byte once a step; an admission's
real prompt tokens, not its padding) / the device time of the `qmm` kernel
group, %. Reads `roofline.qmm.ppl` and `roofline.qmm.serve` alike;
`BENCHMARK.json` names the cells of each."""


def read(ctx):
    bound, busy = ctx.facts.get("qmm_bound_s"), ctx.group_s("qmm")
    if bound is None or busy <= 0:
        return None
    return 100.0 * bound / busy
