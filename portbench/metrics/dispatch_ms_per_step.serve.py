"""Serving engine: the host's milliseconds enqueueing the decode windows
(span `engine.dispatch`) per decode step dispatched (`engine.decode_steps`),
in the traced run."""

from portbench.recorder import counts, span_s


def read(ctx):
    steps = counts().get("engine.decode_steps")
    if not steps:
        return None
    return 1e3 * span_s("engine.dispatch") / steps
