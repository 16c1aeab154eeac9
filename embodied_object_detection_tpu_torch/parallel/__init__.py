"""The training step over a batch of frames."""
