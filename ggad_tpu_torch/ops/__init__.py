"""Sparse ops of the port: SpMM (COO and BCSR), normalization, metrics."""
