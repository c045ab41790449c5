"""The port's benchmark: cells found by name (see README.md)."""
