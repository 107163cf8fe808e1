"""Compute kernels: the CUDA Smith-Waterman kernels with their plain
PyTorch versions, plus NumPy oracles."""
