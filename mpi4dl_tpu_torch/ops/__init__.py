"""Operators of the PyTorch port: the halo-conv kernels (K1, K2), the
single-device subset of the D2 premargin machinery, the block-flash
attention kernel (K3) and ring attention."""
