"""Benchmark harnesses of the port: multi-device scaling efficiency
(`scaling.measure_scaling`)."""

from .scaling import measure_scaling  # noqa: F401
