"""Detector modules (NCHW channels-last backbone, fp32 head)."""
