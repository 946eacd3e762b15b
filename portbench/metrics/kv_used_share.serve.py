"""Serving engine: the share of the KV pool (slots x max_len a decode
step; counter `engine.kv_reserved`) holding a live request's cached
positions (`engine.kv_used`: min(position, max_len) of each live slot, a
step), %."""

from portbench.recorder import counts


def read(ctx):
    c = counts()
    if not c.get("engine.kv_reserved"):
        return None
    return 100.0 * c["engine.kv_used"] / c["engine.kv_reserved"]
