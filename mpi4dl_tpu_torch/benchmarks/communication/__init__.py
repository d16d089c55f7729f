"""Communication-pattern benchmark tools of the PyTorch port."""
