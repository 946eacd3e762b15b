"""Serving engine: the share of the admission prefills' computed positions
(`max_slots` x the bucket, each; counter `engine.prefill_positions`) that
hold a prompt token (`engine.prompt_tokens`), %."""

from portbench.recorder import counts


def read(ctx):
    c = counts()
    if not c.get("engine.prefill_positions"):
        return None
    return 100.0 * c["engine.prompt_tokens"] / c["engine.prefill_positions"]
