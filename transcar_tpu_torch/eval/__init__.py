"""Inference-side decoding."""
