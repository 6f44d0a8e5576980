"""Graph track of the port: synthetic datasets, partitioners and padded
batching (numpy, copied from ``repro.graphs``) and the GNN backbones."""
