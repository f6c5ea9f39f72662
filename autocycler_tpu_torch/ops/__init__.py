"""Device ops of the port: encoding, the sort-network grouping kernel, the
k-mer index, chain following, end repair, graph assembly, the cluster
distance contraction and the dotplot match grids."""
