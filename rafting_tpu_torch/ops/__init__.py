"""Device ops of the PyTorch port: the quorum-commit kernel and its plain version."""
