"""Frame generation for the benchmark (see :mod:`.render`)."""
