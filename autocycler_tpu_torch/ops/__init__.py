"""Device ops of the port: encoding, the sort-network grouping kernel, the
k-mer index, chain following, end repair and graph assembly."""
