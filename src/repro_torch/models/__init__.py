"""Model definitions of the port: plain functions over nested dicts of
tensors, laid out as the JAX package's parameter trees."""
