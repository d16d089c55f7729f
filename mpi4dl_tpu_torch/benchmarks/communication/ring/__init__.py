"""Long-context (ring attention) benchmark tool of the PyTorch port."""
