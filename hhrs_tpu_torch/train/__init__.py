"""train of the PyTorch port."""
