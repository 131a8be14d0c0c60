"""Metrics and run output of the port (numpy and the standard library)."""
