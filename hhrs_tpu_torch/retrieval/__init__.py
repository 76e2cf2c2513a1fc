"""retrieval of the PyTorch port."""
