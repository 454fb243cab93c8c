"""Host utilities of the port: the sweep manifest, counters and meters, logging."""
