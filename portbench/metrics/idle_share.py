"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card (1 - union of their intervals / window), %. Reads
`idle_share.ppl` and `idle_share.serve` alike; `BENCHMARK.json` names the
cells of each."""


def read(ctx):
    if not ctx.trace or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
