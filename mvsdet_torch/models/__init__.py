"""See the package docstring of mvsdet_torch."""
