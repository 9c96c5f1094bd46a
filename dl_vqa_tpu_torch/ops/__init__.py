"""Ops of the port: plain PyTorch versions and the hand-written CUDA
kernels beside them (built on first use, never at import)."""
