"""Device ops (torch) and host tables/oracles (numpy) of the port."""
