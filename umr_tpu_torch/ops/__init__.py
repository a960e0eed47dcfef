"""Tensor ops of the port: quaternions, projection, grid sampling, the
rasterizer's plain version, its binning and the CUDA kernel's wrapper."""
