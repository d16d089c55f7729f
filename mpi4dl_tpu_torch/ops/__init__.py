"""Operators of the PyTorch port: the halo-conv kernels (K1, K2), halo
exchange and the D2 premargin machinery, the H-striped conv and layer run,
the stripe-wise backward, the phase-decomposed strided conv, the
block-flash attention kernel (K3) and ring attention."""
