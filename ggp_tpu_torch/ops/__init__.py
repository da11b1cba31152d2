"""Collapsed-bound core, the NUTS chunk and the Adam chunks, each a plain
PyTorch function beside a wrapper around its hand-written CUDA kernel."""
