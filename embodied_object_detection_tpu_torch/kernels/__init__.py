"""Build and bind the CUDA sources under csrc/."""
