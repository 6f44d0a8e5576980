"""Graph-property serving in the port: segment-streaming inference with a
cross-request segment-embedding cache."""
