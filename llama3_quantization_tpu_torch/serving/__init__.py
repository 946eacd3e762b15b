"""Continuous-batching serving (port of `llama3_quantization_tpu/serving`)."""

from .engine import ServingEngine

__all__ = ["ServingEngine"]
