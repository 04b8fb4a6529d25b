"""Training: the optimizer and one training step."""
