"""Command-line entry points (see the rald_tpu counterpart of this package)."""
