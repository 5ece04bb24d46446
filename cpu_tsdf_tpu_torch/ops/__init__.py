"""Tensor ops of the port: fusion, color, marching cubes and their kernels."""
