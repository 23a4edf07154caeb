"""Sparse ops of the port: SpMM (COO and BCSR), SDDMM and the affinity,
normalization, metrics."""
