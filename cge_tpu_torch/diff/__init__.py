"""Differentiable rendering (counterpart of cge_tpu/diff)."""
