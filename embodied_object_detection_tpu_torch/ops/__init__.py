"""Device ops: hand-written kernels beside their plain PyTorch versions."""
