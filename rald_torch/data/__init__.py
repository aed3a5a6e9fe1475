"""Host-side data handling (see the rald_tpu counterpart of this package)."""
