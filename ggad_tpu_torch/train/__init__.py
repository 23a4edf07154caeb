"""The full-batch trainer, its losses and checkpoints."""
