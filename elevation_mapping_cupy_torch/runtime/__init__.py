"""Host-side runtime of the PyTorch port: the mapping service with its
native frame ring, log replay and fault injection."""
