"""Networks and layers of the port (NCHW)."""
