"""Parallelism settings of the port (one device so far)."""
