"""Compute kernels: dense XLA pipelines and the GPU Pallas kernels."""
