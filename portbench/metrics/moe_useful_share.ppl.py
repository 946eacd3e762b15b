"""Whole step: the share of the MoE's expert rows run (`moe.rows_computed`:
tokens x experts under the dense dispatch) that serve a routed (token,
expert) pick (`moe.rows_routed`), %. k/E under the dense dispatch."""

from portbench.recorder import counts


def read(ctx):
    c = counts()
    if not c.get("moe.rows_computed"):
        return None
    return 100.0 * c["moe.rows_routed"] / c["moe.rows_computed"]
