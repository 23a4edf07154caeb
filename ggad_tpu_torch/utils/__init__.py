"""Utilities of the port: structured jsonl logging."""
