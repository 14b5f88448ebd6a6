"""Operators of the port: the hand-written CUDA kernels and their plain
PyTorch versions (``ops/kernels``)."""
