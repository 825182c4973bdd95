"""Output formats of the port."""
