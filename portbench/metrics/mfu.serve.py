"""Whole step: the least time the window's useful work needs (each decode
step's larger of its operations and bytes bound, plus each admission's) /
the window's wall time, %."""


def read(ctx):
    f = ctx.facts
    if f.get("kind") != "serve" or not f["wall_s"]:
        return None
    return 100.0 * f["step_bound_s"] / f["wall_s"]
