"""parallel of the PyTorch port: the device mesh, the process world and its launcher."""
