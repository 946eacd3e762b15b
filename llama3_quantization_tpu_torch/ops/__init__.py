"""Matmul dispatch, KV cache and the CUDA kernel wrappers."""
