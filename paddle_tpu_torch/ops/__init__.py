"""Attention ops of the port: plain PyTorch versions and the hand-written
Hopper kernels (``csrc/``) behind them."""
