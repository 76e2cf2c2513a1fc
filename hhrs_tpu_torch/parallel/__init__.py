"""parallel of the PyTorch port: the device mesh, the process world and its launcher, and mesh
training's sharding, embedding exchanges, per-rank feeding and train step."""
