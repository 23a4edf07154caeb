"""The benchmark of ``ggad_tpu_torch`` on the H100: cells, metrics, the
plain reference and the check of every run (``harness.py``)."""
