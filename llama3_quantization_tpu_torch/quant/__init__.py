"""Packed low-bit weight storage and the uniform quantizer."""
