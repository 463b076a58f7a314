"""Parallelism of the port: the device mesh, the data and model axes, the
tensor-parallel regions and the leaves' layouts."""
