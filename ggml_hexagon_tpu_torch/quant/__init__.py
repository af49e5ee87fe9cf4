"""Quantization formats, policy and planar tensors (torch planes)."""
