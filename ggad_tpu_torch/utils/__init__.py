"""Utilities of the port: structured jsonl logging and the spans of its
layers (``tracing``)."""
