"""Training engine: solver, checkpoints and the training loop."""
