"""Operators of the PyTorch port: the halo-conv kernels and the
single-device subset of the D2 premargin machinery."""
