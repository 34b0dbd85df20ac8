"""Torch ops and CUDA kernel wrappers of the port."""
