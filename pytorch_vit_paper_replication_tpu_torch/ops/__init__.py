"""Tensor ops of the port: dropout hash, attention dispatch, CUDA kernels."""
