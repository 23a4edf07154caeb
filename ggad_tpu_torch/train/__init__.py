"""Serving members of the full-batch trainer and checkpoints."""
