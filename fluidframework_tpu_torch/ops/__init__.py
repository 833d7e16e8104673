"""Device ops of the port: the overlay chunk kernel, its plain
PyTorch version, the settle-merge fold and the stable partition."""
