"""The port's own spans and counters (`llama3_quantization_tpu_torch/
utils/profiling.py`) as the per-layer readers see them: the recording of
the traced window, read once the window has closed. Where the program
keeps no such recording (a checkout from before it had one), every reader
of it finds nothing and its metric is left out."""

from __future__ import annotations

from typing import Optional


def recorded() -> Optional[dict]:
    """The program's last recording (`profiling.recorded()`), or None."""
    from llama3_quantization_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def counts() -> dict:
    """The recording's counters by name ({} where there is none)."""
    rec = recorded()
    return rec["counts"] if rec else {}


def span_s(name: str, outer: Optional[str] = None) -> float:
    """Host seconds of span `name` under the outermost engine or eval span
    `outer` (by default `name` itself: the span where no other engine or
    eval span holds it); 0 where none ran."""
    rec = recorded()
    if not rec:
        return 0.0
    return rec["spans"].get(name if outer is None else outer, {}).get(name, {}).get(
        "total_s", 0.0)
