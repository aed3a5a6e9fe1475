"""See the rald_tpu counterpart of this package."""
