"""db of the PyTorch port: the sqlite3 schema and the model registry."""
