"""Label embeddings (y -> h) of the port."""
