"""Wrappers: the port's kernel launches (`ops/launches.COUNTS`, every key)
during the window's `step_n` calls, per decode step."""


def read(ctx):
    f = ctx.facts
    if f.get("kind") != "serve" or not f["decode_steps"]:
        return None
    return f["launches"] / f["decode_steps"]
