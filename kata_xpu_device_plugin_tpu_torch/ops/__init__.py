"""Attention, quantization and the CUDA kernels of the port."""
