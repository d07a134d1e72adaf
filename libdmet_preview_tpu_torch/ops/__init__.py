"""Tensor operators, fit engines, kernels and the fused iteration."""
