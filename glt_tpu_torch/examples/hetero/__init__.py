"""The port's counterparts of examples/hetero/: link prediction over a
bipartite user-item graph, HGT and RGNN on an ogbn-mag-shaped graph, and
hierarchical (per-layer trimmed) hetero GraphSAGE."""
