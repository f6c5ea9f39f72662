"""Device ops of the port: encoding, the k-mer grouping (partition-sort) kernels, the
k-mer index, chain following, end repair, graph assembly, the cluster
distance contraction and the dotplot match grids."""
