"""Tensor ops: plain PyTorch versions and the CUDA kernel wrappers."""
