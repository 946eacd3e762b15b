"""Whole step: the share of the decode windows' host dispatch (span
`engine.dispatch`) spent inside the attention blocks with their
projections (`model.attn` under `engine.dispatch`), %."""

from portbench.recorder import span_s


def read(ctx):
    dispatch = span_s("engine.dispatch")
    if dispatch <= 0:
        return None
    return 100.0 * span_s("model.attn", "engine.dispatch") / dispatch
