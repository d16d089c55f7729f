"""Benchmark tools of the PyTorch port, mirroring ``benchmarks/``."""
