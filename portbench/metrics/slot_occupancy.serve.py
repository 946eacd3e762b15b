"""Serving engine: the share of the decode steps' slot rows that carried a
live request's token (tokens from decode / (decode steps x slots)), %."""


def read(ctx):
    f = ctx.facts
    if f.get("kind") != "serve" or not f["decode_steps"]:
        return None
    return 100.0 * f["decode_tokens"] / (f["decode_steps"] * f["slots"])
