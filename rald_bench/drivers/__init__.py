"""Traffic drivers, found by the name a traffic mix gives."""
