"""Core data structures of the PyTorch port: devices, volumes, fits, maps."""
