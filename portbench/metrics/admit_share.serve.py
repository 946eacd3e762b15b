"""Serving engine: the share of the window's wall time spent inside the
benchmark's `add_requests` calls (admission prefills), %."""


def read(ctx):
    f = ctx.facts
    if f.get("kind") != "serve" or not f["wall_s"]:
        return None
    return 100.0 * f["admit_s"] / f["wall_s"]
