"""Host utilities of the port: the sweep manifest and the scheduler counters."""
