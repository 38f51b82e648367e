"""Engine core of the PyTorch port: types, PRNG twin, step, cluster, sim."""
