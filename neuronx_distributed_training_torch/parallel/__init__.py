"""Parallelism of the port: the device mesh and the data axis."""
