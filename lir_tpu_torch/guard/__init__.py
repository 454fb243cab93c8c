"""Guard layer of the port: the numerics check of scored rows."""
