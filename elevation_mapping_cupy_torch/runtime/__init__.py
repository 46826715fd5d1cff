"""Host-side runtime of the PyTorch port: log replay and fault injection."""
