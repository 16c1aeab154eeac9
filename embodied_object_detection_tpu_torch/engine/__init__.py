"""Engine: solver, checkpoints, the training loop and the evaluation
engine's external GT-memory table."""
