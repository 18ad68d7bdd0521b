"""Framework-free cost models of the port (``roofline``)."""
