"""See the package docstring of rectdetect_tpu_torch."""
