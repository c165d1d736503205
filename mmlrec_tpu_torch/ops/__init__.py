"""Layers, embedding stores and the hand-written CUDA kernels of the port."""
