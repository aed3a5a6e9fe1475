"""Plain float32 PyTorch reference of the measured models (no import of the
system under test)."""
